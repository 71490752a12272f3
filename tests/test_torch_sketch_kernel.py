"""The read sketch kernel (``csrc/sketch.cu``) against the torch chain
(``ops/sketch.py`` ``sketch_ref``), byte for byte, on the card; they skip
on the CPU. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sketch_kernel.py

(the numpy model of the kernel's algorithm is held to the torch chain on the
CPU in ``tests/test_torch_sketch_model.py``)."""
import time

import numpy as np
import pytest
import torch

from metamaps_tpu_torch import trace
from metamaps_tpu_torch.engine import mapper_oracle
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.engine.mapper_torch import MapConfig, TorchMapperEngine
from metamaps_tpu_torch.ops.sketch import (RB_MAX, sketch, sketch_plan,
                                           sketch_ref)
from metamaps_tpu_torch.ops.winnow import winnow_np
from metamaps_tpu_torch.params import Parameters

from util_sim import random_genome, sample_reads

pytestmark = pytest.mark.cuda

BUCKETS = TorchMapperEngine.DEFAULT_BUCKETS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _odd(rng, n):
    """``n`` bases: random upper case with stretches of lower case, N,
    ACGT repeats (symmetric k-mers) and homopolymers (the wpos-0 chain)."""
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    for _ in range(max(n // 700, 1)):
        at = int(rng.integers(0, n))
        span = slice(at, at + int(rng.integers(10, 200)))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            s[span] += 32  # lower case
        elif kind == 1:
            s[span] = ord("N")
        elif kind == 2:
            piece = s[span]
            s[span] = np.resize(np.frombuffer(b"ACGT", np.uint8), piece.size)
        else:
            s[span] = ord("A")
    return s


def _batch(seqs, L, pad=ord("A")):
    reads = np.full((len(seqs), L), pad, np.uint8)
    lens = np.zeros(len(seqs), np.int64)
    for i, s in enumerate(seqs):
        reads[i, :len(s)] = s[:L]
        lens[i] = len(s)
    return reads, lens


def _check(cuda, reads, lens, k, w, S, a=4):
    r = torch.from_numpy(reads).to(cuda)
    n = torch.from_numpy(lens).to(cuda)
    before = sketch.launches
    got = sketch(r, n, k, w, S, a)
    torch.cuda.synchronize()
    assert sketch.launches == before + 1
    want = sketch_ref(r, n, k, w, S, a)
    for name, g, w_ in zip(("q_hash", "q_strand", "size", "overflow"), got,
                           want):
        assert g.dtype == w_.dtype and g.shape == w_.shape, name
        assert torch.equal(g, w_), name
    return want


@pytest.mark.parametrize("B", [1, 83, 890, 1024])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_every_bucket(cuda, bucket, B):
    """Reads of the bucket's lengths (some shorter: the padding) at the
    engine's capacities for k 16, w 16."""
    rng = np.random.default_rng(bucket * 7 + B)
    lo = max(b for b in (0,) + BUCKETS if b < bucket)
    lens = rng.integers(max(lo, 20), bucket + 1, B)
    short = rng.random(B) < 0.1
    lens[short] = rng.integers(1, bucket + 1, int(short.sum()))
    reads, lens = _batch([_odd(rng, int(n)) for n in lens], bucket)
    S = MapConfig.for_read_len(bucket, 16, 16).sketch_max
    _check(cuda, reads, lens, 16, 16, S)


@pytest.mark.parametrize("k", [15, 16, 17, 31, 33])
@pytest.mark.parametrize("w", [1, 5, 16, 50])
@pytest.mark.parametrize("a", [4, 20])
def test_k_w_and_alphabet(cuda, k, w, a):
    rng = np.random.default_rng(k * 100 + w + a)
    n = rng.integers(1, 3000, 67)
    n[:3] = (k - 1, k + w - 2, k + w - 1)  # no k-mer, no window, one window
    reads, lens = _batch([_odd(rng, int(x)) for x in n], 3072)
    S = MapConfig.for_read_len(3072, k, w).sketch_max
    _check(cuda, reads, lens, k, w, S, a)


def test_lower_case_n_repeats_and_homopolymers(cuda):
    rng = np.random.default_rng(3)
    seqs = [np.full(2000, ord("A"), np.uint8), np.full(2000, ord("a"), np.uint8),
            np.resize(np.frombuffer(b"ACGT", np.uint8), 2000),
            np.full(2000, ord("N"), np.uint8),
            np.resize(np.frombuffer(b"acgtN", np.uint8), 2000),
            random_genome(rng, 20)]
    for _ in range(20):
        seqs.append(_odd(rng, 2048))
    for pad in (ord("A"), 0, ord("n")):  # the padding's bytes do not matter
        _check(cuda, *_batch(seqs, 2048, pad), 16, 16, 256)


def test_exactly_s_and_s_plus_one_unique(cuda):
    rng = np.random.default_rng(4)
    reads, lens = _batch([_odd(rng, 4000) for _ in range(9)], 4096)
    r = torch.from_numpy(reads).to(cuda)
    n = torch.from_numpy(lens).to(cuda)
    full = sketch_ref(r, n, 16, 16, 4096)[2]
    assert not sketch_ref(r, n, 16, 16, 4096)[3].any()
    for row in range(9):
        u = int(full[row])
        one = (reads[row:row + 1], lens[row:row + 1])
        want = _check(cuda, *one, 16, 16, u)  # exactly S
        assert not bool(want[3][0]) and int(want[2][0]) == u
        want = _check(cuda, *one, 16, 16, u - 1)  # S + 1
        assert bool(want[3][0]) and int(want[2][0]) == u - 1


@pytest.mark.parametrize("w,S", [(1, 82048), (16, 128), (5, 4096)],
                         ids=["every_window", "small_buffer", "cap"])
def test_records_beyond_the_on_chip_buffer(cuda, w, S):
    """Reads whose records outgrow the shared-memory buffer: the flush to
    the workspace, its merges and its cap at S + 1."""
    L = 65536
    kcap, rb, spills, gring = sketch_plan(L, 16, w, S)
    assert spills and rb <= RB_MAX and not gring
    rng = np.random.default_rng(w)
    seqs = [_odd(rng, L), _odd(rng, L - 1000), random_genome(rng, 30000),
            np.full(L, ord("C"), np.uint8)]
    reads, lens = _batch(seqs, L)
    want = _check(cuda, reads, lens, 16, w, S)
    if w == 1:  # more records than the buffer holds, and no overflow
        assert int(want[2][0]) > rb and not bool(want[3][0])
    else:
        assert bool(want[3][0])


@pytest.mark.parametrize("w", [15361, 15362, 20000],
                         ids=["widest_shared_ring", "ring_in_workspace",
                              "wide_ring_in_workspace"])
def test_windows_too_wide_for_shared_memory(cuda, w):
    """The widest window whose ring shared memory holds, and wider ones,
    whose ring the kernel keeps in a workspace: three reads, so each
    block's slice of the ring and of its strand bytes is its own."""
    rng = np.random.default_rng(w)
    seqs = [_odd(rng, 30000), random_genome(rng, 32768),
            _odd(rng, w + 20)]
    gring = sketch_plan(32768, 16, w, 512)[3]
    assert gring == (w > 15361)
    _check(cuda, *_batch(seqs, 32768), 16, w, 512)


def test_wrapper_rejects_bad_input(cuda):
    r = torch.zeros((2, 100), dtype=torch.uint8, device=cuda)
    n = torch.full((2,), 100, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        sketch(r, n, 16, 90, 128)  # no window in the padded length
    with pytest.raises(TypeError):
        sketch(r.int(), n, 16, 16, 128)
    with pytest.raises(ValueError):
        sketch(r, n[:1], 16, 16, 128)


def test_engine_on_card_matches_oracle_with_the_kernel(cuda):
    """A few hundred reads over four length buckets through the engine on
    the card, line for line against the serial oracle; every chunk's span
    says the kernel sketched it."""
    rng = np.random.default_rng(18)
    genomes = [random_genome(rng, 60000) for _ in range(4)]
    params = Parameters(kmer_size=16, window_size=16, min_read_length=2000,
                        percentage_identity=80.0)
    shard = SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        parts.append((*winnow_np(g, 16, 16), i))
        shard.contig_names.append(f"C{i}")
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    seqs = [r[0] for r in sample_reads(rng, genomes, 300, min_len=2000,
                                       max_len=8000, sub=0.08)]
    seqs += [_odd(rng, 5000), random_genome(rng, 3000)]
    engine = TorchMapperEngine(shard, params, device="cuda")
    before = sketch.launches
    t0 = time.perf_counter_ns()
    got = engine.map_reads(seqs)
    torch.cuda.synchronize()
    chunks = [s for s in trace.spans()
              if s.name == "engine.chunk" and s.t0_ns >= t0]
    assert sketch.launches - before == len(chunks) >= 4
    assert all(c.attrs["sketch_kernel"] == 1 for c in chunks)
    for i, seq in enumerate(seqs):
        assert got[i] == mapper_oracle.map_read(shard, params, seq), f"read {i}"
