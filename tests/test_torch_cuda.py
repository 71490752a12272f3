"""Tests of the port that need an NVIDIA card; they skip on the CPU.

This file imports no JAX, so that it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.) Each
sweep kernel must equal its plain version bit for bit: both are exact int32.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from metamaps_tpu_torch.engine import mapper_oracle
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.ops.l2_sweep import (
    BATCH_SP_MAX,
    l2_event_sweep,
    l2_event_sweep_batch,
    l2_event_sweep_rb,
    l2_event_sweep_ref,
    l2_event_sweep_split_ref,
    l2_event_sweep_wide,
    long_event_stream,
    paired_event_streams,
    random_event_streams,
    wide_plan,
)
from metamaps_tpu_torch.ops.l2_sweep_parts import (
    l2_sweep_parts,
    l2_sweep_parts_ref,
    parts_config,
)
from metamaps_tpu_torch.params import Parameters
from metamaps_tpu_torch.profiling.sweep_bench import parts_streams
from metamaps_tpu_torch.ops.winnow import winnow_np

from util_sim import random_genome, revcomp, sample_reads

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("sp,e2,seed", [(128, 300, 0), (1152, 700, 1),
                                        (6272, 400, 2), (10240, 257, 3)])
def test_sweep_kernel_equals_plain(cuda, sp, e2, seed):
    """Random contract-conforming streams; sp 6272 and 10240 need more than
    48 KB of shared memory per block."""
    rng = np.random.default_rng(seed)
    arrs = random_event_streams(rng, 67, e2, sp - 1)
    cpu = [torch.from_numpy(a) for a in arrs]
    dev = [a.to(cuda) for a in cpu]
    before = l2_event_sweep_batch.launches
    got = l2_event_sweep_batch(*dev, sp)
    torch.cuda.synchronize()
    assert l2_event_sweep_batch.launches == before + 1
    want = l2_event_sweep_ref(*cpu, sp)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("flip", [0.0, 0.04], ids=["paired", "mixed"])
@pytest.mark.parametrize("sp,e2,seed", [(128, 300, 4), (1280, 700, 5),
                                        (10240, 400, 6)])
def test_sweep_kernel_equals_plain_on_paired_streams(cuda, sp, e2, seed,
                                                     flip):
    """Streams shaped like the setup's (incremental mode only) and mixed
    ones, in which ranks go negative and recover (recount mode and back);
    sp 10240 needs more than 48 KB of shared memory per block."""
    arrs = paired_event_streams(np.random.default_rng(seed), 67, e2, sp - 1,
                                flip=flip)
    cpu = [torch.from_numpy(a) for a in arrs]
    before = l2_event_sweep_batch.launches
    got = l2_event_sweep_batch(*[a.to(cuda) for a in cpu], sp)
    torch.cuda.synchronize()
    assert l2_event_sweep_batch.launches == before + 1
    assert torch.equal(got.cpu(), l2_event_sweep_ref(*cpu, sp))


def test_sweep_kernel_empty_and_full_candidates(cuda):
    """One candidate with no events beside one with E2 of them (several
    tiles of staged events, the last one partial), and E2 not a multiple
    of 4 (rows not 16-byte aligned)."""
    e2, sp = 1001, 256
    arrs = [a.copy() for a in paired_event_streams(
        np.random.default_rng(8), 9, e2 - 1, sp - 1)]
    meta, qrank, signinq, rows = arrs
    pad = lambda a, fill: np.pad(a, ((0, 0), (0, 1)), constant_values=fill)
    qrank, signinq, rows = pad(qrank, 0), pad(signinq, 0), pad(rows, 2**31 - 1)
    meta[0, 3] = 0  # candidate 0 has no events
    rows[1] = np.sort(np.random.default_rng(9).integers(0, 5000, e2))
    i = np.arange(e2)  # candidate 1 has E2: add, add, remove, remove
    signinq[1] = np.array([2, 1, -2, -1])[i % 4]
    qrank[1] = (i // 4 * 7 + np.array([0, 3, 0, 3])[i % 4]) % sp
    meta[1] = (200, 0, 5000, e2)
    cpu = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (meta, qrank, signinq, rows)]
    got = l2_event_sweep_batch(*[a.to(cuda) for a in cpu], sp)
    torch.cuda.synchronize()
    want = l2_event_sweep_ref(*cpu, sp)
    assert torch.equal(got.cpu(), want)
    assert want[0].tolist() == [0, -1, -1, 0] and int(want[1, 0]) > 0


def test_sweep_wrapper_rejects_bad_input(cuda):
    arrs = [torch.from_numpy(a).to(cuda) for a in
            random_event_streams(np.random.default_rng(5), 4, 16, 100)]
    with pytest.raises(TypeError):
        l2_event_sweep_batch(arrs[0].long(), *arrs[1:], 128)
    with pytest.raises(ValueError):
        l2_event_sweep_batch(*arrs, 100)
    with pytest.raises(ValueError):
        l2_event_sweep_batch(arrs[0].cpu(), *arrs[1:], 128)


def test_engine_on_card_matches_oracle(cuda):
    rng = np.random.default_rng(33)
    genomes = [random_genome(rng, 50000) for _ in range(3)]
    params = Parameters(kmer_size=16, window_size=16, min_read_length=2000,
                        percentage_identity=80.0)
    shard = SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        h, p, s = winnow_np(g, 16, 16)
        parts.append((h, p, s, i))
        shard.contig_names.append(f"C{i}")
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    seqs = [r[0] for r in sample_reads(rng, genomes, 24, min_len=2000,
                                       max_len=7000, sub=0.08)]
    g = genomes[0]
    seqs += [np.tile(g[1000:1400], 8), revcomp(g[20000:24096]),
             random_genome(rng, 3000)]
    engine = TorchMapperEngine(shard, params, device="cuda")
    before = l2_event_sweep_batch.launches
    got = engine.map_reads(seqs)
    torch.cuda.synchronize()
    assert l2_event_sweep_batch.launches > before
    for i, seq in enumerate(seqs):
        assert got[i] == mapper_oracle.map_read(shard, params, seq), f"read {i}"


def _long_read_case(rng, window):
    """Two random 100 kb genomes as one shard at k 16 and ``window``, a
    60 kb read of the first (its start) and a 5 kb read of the second."""
    genomes = [random_genome(rng, 100_000) for _ in range(2)]
    shard = SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        h, p, s = winnow_np(g, 16, window)
        parts.append((h, p, s, i))
        shard.contig_names.append(f"C{i}")
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    long_read, _, start, _ = sample_reads(rng, genomes[:1], 1, min_len=60_000,
                                          max_len=60_001, sub=0.02)[0]
    return shard, long_read, start, revcomp(genomes[1][30_000:35_000])


def test_long_read_at_pi75_sweeps_wide_on_the_card(cuda):
    """A 60 kb read at --pi 75 (w = 3) sketches to ~30,000 hashes, whose
    minimum hits (~250) are beyond the JAX detector's shift limit of 32, so
    the JAX engine sends it to the serial oracle. The port's L1 has no such
    limit: the read's slab is swept on the card by the wide kernel, with no
    oracle fallback, and it gets the oracle's lines (about a minute of host
    time for the oracle), while a read of ordinary length beside it goes
    through the batch kernel."""
    shard, long_read, _, short = _long_read_case(np.random.default_rng(60), 3)
    params = Parameters(kmer_size=16, window_size=3, min_read_length=1000,
                        percentage_identity=75.0)
    assert mapper_oracle.sketch_read(long_read, 16, 3)[0].size >= BATCH_SP_MAX
    engine = TorchMapperEngine(shard, params, device="cuda")
    before = (l2_event_sweep_wide.launches, l2_event_sweep_batch.launches)
    got = engine.map_reads([long_read, short])
    torch.cuda.synchronize()
    assert engine.stats["oracle_fallbacks"] == 0
    assert l2_event_sweep_wide.launches > before[0]
    assert l2_event_sweep_batch.launches > before[1]
    assert got[1] == mapper_oracle.map_read(shard, params, short)
    assert got[0] and got[0] == mapper_oracle.map_read(shard, params,
                                                       long_read)


def test_long_read_sweeps_wide_on_the_card(cuda):
    """The same 60 kb read at --pi 60 (minimum hits ~19) reaches L2: its
    slab's planes (sp 30,080 or so) are wider than BATCH_SP_MAX, so the
    sweep runs on the wide kernel, bit for bit the plain version on the
    read's real slab, and the read maps where it was drawn, with no oracle
    fallback."""
    shard, long_read, start, short = _long_read_case(
        np.random.default_rng(61), 3)
    params = Parameters(kmer_size=16, window_size=3, min_read_length=1000,
                        percentage_identity=60.0)
    engine = TorchMapperEngine(shard, params, device="cuda")
    before = (l2_event_sweep_wide.launches, l2_event_sweep_batch.launches)
    got = engine.map_reads([long_read, short])
    torch.cuda.synchronize()
    assert engine.stats["oracle_fallbacks"] == 0
    assert l2_event_sweep_wide.launches > before[0]
    assert l2_event_sweep_batch.launches > before[1]
    assert got[1] == mapper_oracle.map_read(shard, params, short)
    best = max(got[0], key=lambda m: m.conserved)
    assert best.ref_seqid == 0 and abs(best.ref_start - start) < 3000
    assert best.nuc_identity > 80
    slabs = engine.l2_slab_setups([long_read])
    assert slabs and all(sp > BATCH_SP_MAX for _, sp in slabs)
    for st, sp in slabs:
        arrs = (st.meta, st.qrank, st.signinq, st.rows)
        got_sweep = l2_event_sweep_wide(*arrs, sp)
        assert torch.equal(got_sweep, l2_event_sweep_ref(*arrs, sp))


@pytest.mark.parametrize("flip", [None, 0.0, 0.04],
                         ids=["random", "paired", "mixed"])
@pytest.mark.parametrize("sp,e2,seed", [(1280, 600, 0), (28928, 300, 1),
                                        (41088, 200, 2)])
def test_wide_kernel_equals_plain(cuda, sp, e2, seed, flip):
    """Planes in device memory: at a width the shared-memory kernel also
    takes, just above BATCH_SP_MAX, and at the widest bucket's plane; 37
    candidates leave a partial block of 8 warps."""
    rng = np.random.default_rng(seed)
    arrs = (random_event_streams(rng, 37, e2, sp - 1) if flip is None
            else paired_event_streams(rng, 37, e2, sp - 1, flip=flip))
    cpu = [torch.from_numpy(a) for a in arrs]
    before = l2_event_sweep_wide.launches
    got = l2_event_sweep_wide(*[a.to(cuda) for a in cpu], sp)
    torch.cuda.synchronize()
    assert l2_event_sweep_wide.launches == before + 1
    assert torch.equal(got.cpu(), l2_event_sweep_ref(*cpu, sp))


# long streams that the wide kernel splits: (sp, E2, kind); each kind at
# both widths, E2 from 4,096 to 20,000, 1-3 candidates
LONG_WIDE = [(sp, e2, kind) for sp in (28928, 41088)
             for e2, kind in ((4096, "random"), (20000, "paired"),
                              (12000, "mixed"))]
_long_wide_cache: dict = {}


def _long_wide(cuda, sp, e2, kind):
    """A long stream on the card and the plain version's output on it,
    computed once per stream: 3 random-sign candidates (the first empty),
    or one paired / mixed candidate of E2 events and an empty one."""
    key = (sp, e2, kind)
    if key not in _long_wide_cache:
        rng = np.random.default_rng(e2 + sp)
        if kind == "random":  # every candidate's rows all scored
            arrs = random_event_streams(rng, 3, e2, sp - 1, row_span=e2)
            arrs[0][:, 1:3] = (-100, e2 + 100)
        else:
            one = long_event_stream(rng, e2, sp - 1,
                                    flip=0.04 if kind == "mixed" else 0.0)
            arrs = [np.concatenate([a, np.zeros_like(a)]) for a in one]
        dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
               for a in arrs]
        _long_wide_cache[key] = dev, l2_event_sweep_ref(*dev, sp)
    return _long_wide_cache[key]


@pytest.mark.parametrize("chunk", [1, 63, 64, 65, None],
                         ids=["L1", "L63", "L64", "L65", "default"])
@pytest.mark.parametrize("sp,e2,kind", LONG_WIDE)
def test_wide_kernel_equals_plain_on_long_streams(cuda, sp, e2, kind, chunk):
    """Streams long enough to be split into many chunks, at every forced
    chunk length and the default one (L = 1 sweeps in windows of chunks:
    its chunks' planes exceed the workspace cap). One launch per call."""
    dev, want = _long_wide(cuda, sp, e2, kind)
    L, P, W, G = wide_plan(dev[1].shape[0], e2, sp,
                           torch.cuda.get_device_properties(cuda)
                           .multi_processor_count, chunk)
    assert P > 1 and (chunk != 1 or W < P)
    before = l2_event_sweep_wide.launches
    got = l2_event_sweep_wide(*dev, sp, chunk_events=chunk)
    torch.cuda.synchronize()
    assert l2_event_sweep_wide.launches == before + 1
    assert torch.equal(got, want)
    assert int(want[:, 0].max()) > 0


def test_split_ref_equals_plain_on_the_card(cuda):
    """The decomposition's plain model on the card, at the default chunk
    length of a long mixed stream, as the smoke uses it to locate a
    mismatch."""
    dev, want = _long_wide(cuda, 28928, 12000, "mixed")
    L = wide_plan(2, 12000, 28928, 132)[0]
    assert torch.equal(l2_event_sweep_split_ref(*dev, 28928, L), want)


def test_batch_sweep_hands_wide_planes_on(cuda):
    """Above BATCH_SP_MAX the batch wrapper launches the wide kernel (its
    count, not the batch kernel's); at BATCH_SP_MAX its own."""
    arrs = [torch.from_numpy(a).to(cuda) for a in random_event_streams(
        np.random.default_rng(7), 9, 100, 1000)]
    for sp, kernel in ((BATCH_SP_MAX, "batch"), (BATCH_SP_MAX + 128, "wide")):
        before = (l2_event_sweep_batch.launches, l2_event_sweep_wide.launches)
        got = l2_event_sweep_batch(*arrs, sp)
        torch.cuda.synchronize()
        after = (l2_event_sweep_batch.launches, l2_event_sweep_wide.launches)
        assert [b - a for a, b in zip(before, after)] == (
            [1, 0] if kernel == "batch" else [0, 1])
        assert torch.equal(got, l2_event_sweep_ref(*arrs, sp))


@pytest.mark.parametrize("sp,e2,seed", [(128, 300, 0), (1152, 700, 1),
                                        (3584, 400, 2)])
def test_rb_kernel_equals_plain(cuda, sp, e2, seed):
    """67 candidates leave a partial block of 8 warps; sp 1152 and 3584
    need more than 48 KB of shared memory per block (64 * sp bytes)."""
    arrs = random_event_streams(np.random.default_rng(seed), 67, e2, sp - 1)
    cpu = [torch.from_numpy(a) for a in arrs]
    before = l2_event_sweep_rb.launches
    got = l2_event_sweep_rb(*[a.to(cuda) for a in cpu], sp)
    torch.cuda.synchronize()
    assert l2_event_sweep_rb.launches == before + 1
    assert torch.equal(got.cpu(), l2_event_sweep_ref(*cpu, sp))


@pytest.mark.parametrize("s_pad,e2,seed", [(1024, 300, 0), (2048, 700, 1),
                                           (10240, 257, 2)])
def test_eager_kernel_equals_plain(cuda, s_pad, e2, seed):
    """row_hi = INT32_MAX on every fourth candidate: row_hi + 1 must not
    overflow in the kernel."""
    arrs = random_event_streams(np.random.default_rng(seed), 67, e2, s_pad - 1)
    arrs[0][::4, 2] = 2**31 - 1
    cpu = [torch.from_numpy(a) for a in arrs]
    before = l2_event_sweep.launches
    got = l2_event_sweep(*[a.to(cuda) for a in cpu], s_pad)
    torch.cuda.synchronize()
    assert l2_event_sweep.launches == before + 1
    assert torch.equal(got.cpu(), l2_event_sweep_ref(*cpu, s_pad))


@pytest.mark.parametrize("flip", [0.0, 0.04], ids=["paired", "mixed"])
@pytest.mark.parametrize("name,width,e2,seed", [
    ("rb", 128, 300, 10), ("rb", 1280, 700, 11), ("rb", 3584, 400, 12),
    ("eager", 1024, 300, 13), ("eager", 2048, 700, 14),
    ("eager", 10240, 257, 15)])
def test_rb_and_eager_equal_plain_on_paired_streams(cuda, name, width, e2,
                                                    seed, flip):
    """Setup-shaped streams (lane 0's O(1) chain only) and mixed ones, in
    which ranks go negative and recover (the warp's or the block's recount,
    and back). 67 candidates: rb's last block of 8 is partial; eager's
    blocks take 512 threads."""
    fn = {"rb": l2_event_sweep_rb, "eager": l2_event_sweep}[name]
    arrs = paired_event_streams(np.random.default_rng(seed), 67, e2,
                                width - 1, flip=flip)
    arrs[0][::5, 2] = 2**31 - 1  # row_hi + 1 must not overflow (eager)
    cpu = [torch.from_numpy(a) for a in arrs]
    before = fn.launches
    got = fn(*[a.to(cuda) for a in cpu], width)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got.cpu(), l2_event_sweep_ref(*cpu, width))


@pytest.mark.parametrize("n", [600, 1200, 2100])
def test_eager_kernel_block_sizes(cuda, n):
    """Enough candidates that eager's blocks shrink to reside at once (256
    threads at 600, 128 at 1200 and 2100 on 132 SMs), on mixed streams:
    the chain and the block's recount at each size."""
    arrs = paired_event_streams(np.random.default_rng(n), n, 200, 2047,
                                flip=0.04)
    cpu = [torch.from_numpy(a) for a in arrs]
    got = l2_event_sweep(*[a.to(cuda) for a in cpu], 2048)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), l2_event_sweep_ref(*cpu, 2048))


def _parts_on_card(cuda, cpu, sp, mode, splits=None):
    """The ablation kernel against its plain version on the same inputs:
    output, fold state and planes, bit for bit, and one launch counted."""
    before = l2_sweep_parts.launches
    got = l2_sweep_parts(*[a.to(cuda) for a in cpu], sp, mode, splits=splits)
    torch.cuda.synchronize()
    assert l2_sweep_parts.launches == before + 1
    want = l2_sweep_parts_ref(*cpu, sp, mode)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    return want


@pytest.mark.parametrize("mode", ["cms", "cmsf", "cmf", "s", "c", "m", "f",
                                  "cm"])
def test_parts_kernel_equals_plain(cuda, mode):
    """Output, fold state and planes, at a small ablation shape (E2 = 3 *
    128 + 45: the tail is not swept; 12 candidates: four CTAs each)."""
    cpu = [torch.from_numpy(a) for a in parts_streams(12, 1152, 429, seed=4)]
    assert parts_config(12, 1152)["splits"] == 4
    out, _, planes = _parts_on_card(cuda, cpu, 1152, mode)
    assert bool(out.any()) == ("m" in mode and "s" in mode)
    assert bool(planes[:, 0].any()) == ("c" in mode)


@pytest.mark.parametrize("n,sp,e2,splits", [
    (12, 1152, 429, 1), (12, 1152, 429, 4), (56, 1152, 700, 3),
    (200, 1152, 300, None), (33, 384, 300, None), (9, 256, 1000, 2),
    (20, 384, 100, None)])
def test_parts_kernel_splits(cuda, n, sp, e2, splits):
    """Ranks split over 1 to 4 CTAs of a cluster, forced or by default (200
    candidates: one CTA each, four ranks a thread); sp 256 and 384 leave
    padding ranks past sp; ranks below 0 and at or above sp; E2 = 100 <
    128 sweeps nothing and must write zeros."""
    rng = np.random.default_rng(n + sp + e2)
    meta, _, signinq, rows = parts_streams(n, sp, e2, seed=n)
    qrank = rng.integers(-3, sp + 3, (n, e2)).astype(np.int32)
    meta[:, 0] = rng.integers(-2, sp + 40, n)
    cpu = [torch.from_numpy(a) for a in (meta, qrank, signinq, rows)]
    for mode in ("cmsf", "cm"):
        out, fold, planes = _parts_on_card(cuda, cpu, sp, mode, splits)
        if e2 < 128:
            assert not out.any() and not fold.any() and not planes.any()
        elif mode == "cmsf":
            assert (out[:, 0] > 0).sum() > n // 2


def test_variant_wrappers_reject_bad_widths(cuda):
    arrs = [torch.from_numpy(a).to(cuda) for a in
            random_event_streams(np.random.default_rng(5), 4, 16, 100)]
    l2_event_sweep_rb(*arrs, 6656)  # 32 * 6656 + 16384 B = 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        l2_event_sweep_rb(*arrs, 6784)  # 32 * 6784 + 16384 B > 227 KB
    with pytest.raises(ValueError, match="multiple of 1024"):
        l2_event_sweep(*arrs, 1152)
    # int16 planes: at most 32767 events per candidate
    wide = [arrs[0]] + [torch.nn.functional.pad(a, (0, 32768 - 16))
                        for a in arrs[1:]]
    for fn, width in ((l2_event_sweep_rb, 128), (l2_event_sweep, 1024)):
        with pytest.raises(ValueError, match="int16"):
            fn(*wide, width)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="mode letters"):
        l2_sweep_parts(*arrs, 1152, "cmq")
    with pytest.raises(TypeError):
        l2_sweep_parts(arrs[0].long(), *arrs[1:], 1152, "cms")
    # the ranks of one CTA: at most 31 warps of 32 threads of 4 ranks
    many = [torch.from_numpy(a).to(cuda) for a in
            random_event_streams(np.random.default_rng(6), 500, 16, 100)]
    assert parts_config(500, 3968)["splits"] == 1
    l2_sweep_parts(*many, 3968, "cmsf")
    with pytest.raises(ValueError, match="too wide"):
        l2_sweep_parts(*many, 3968 + 128, "cmsf")
    with pytest.raises(ValueError, match="splits"):
        l2_sweep_parts(*arrs, 1152, "cmsf", splits=5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["batch", "rb", "eager", "parts", "wide"])
def test_empty_input_launches_nothing(cuda, name):
    """N = 0 candidates: an empty result, no kernel launched, no count."""
    wrapper, width = {
        "batch": (l2_event_sweep_batch, (1152,)),
        "wide": (l2_event_sweep_wide, (28928,)),
        "rb": (l2_event_sweep_rb, (1152,)),
        "eager": (l2_event_sweep, (2048,)),
        "parts": (l2_sweep_parts, (1152, "cmsf")),
    }[name]
    meta = torch.zeros((0, 4), dtype=torch.int32, device=cuda)
    events = [torch.zeros((0, 64), dtype=torch.int32, device=cuda)
              for _ in range(3)]
    before = wrapper.launches
    got = wrapper(meta, *events, *width)
    torch.cuda.synchronize()
    assert wrapper.launches == before
    for out in got[:2] if isinstance(got, tuple) else (got,):
        assert out.shape == (0, 4)
    if name == "parts":
        assert got[2].shape == (0, 2, 1152)


MESH_MAP_SUFFIXES = ("", ".meta", ".meta.unmappedReadsLengths")


@pytest.fixture(scope="module")
def mesh_mini(tmp_path_factory):
    """``tests/test_sharded_product.py``'s database (6 genomes x 24 kb, 24
    reads) and the port's one-device ``mapDirectly`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from metamaps_tpu_torch.cli import main as port_cli_main

    from util_db import make_mini_db, write_reads_fastq

    root = tmp_path_factory.mktemp("mesh_card")
    db = str(root / "DB")
    rng = np.random.default_rng(20240817)
    genomes, _, _ = make_mini_db(db, rng, n_genomes=6, genome_len=24000)
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, sample_reads(rng, genomes, 24, min_len=2200,
                                       max_len=4000, sub=0.07))
    argv = ["mapDirectly", "--reference", f"{db}/DB.fa", "--query", fq,
            "--all", "--minReadLen", "2000"]
    out1 = str(root / "single")
    assert port_cli_main(argv + ["--output", out1]) == 0
    return db, argv, out1


def test_mesh_on_four_ranks_of_one_card(mesh_mini, tmp_path):
    """shard=2,data=2 on four ranks of cuda:0 writes the one-device bytes,
    through the batch sweep kernel."""
    from metamaps_tpu_torch import cli
    from metamaps_tpu_torch.parallel.sharded_engine import map_directly_sharded

    db, argv, out1 = mesh_mini
    out = str(tmp_path / "mesh")
    args = cli._parser().parse_args(argv + ["--output", out])
    params = cli._sketch_params(args)
    cli._query_params(params, args)
    before = l2_event_sweep_batch.launches
    stats = {}
    map_directly_sharded(params, 2, 2, devices=["cuda:0"] * 4,
                         engine_stats=stats)
    torch.cuda.synchronize()
    assert l2_event_sweep_batch.launches > before
    assert stats["oracle_fallbacks"] == 0 and stats["reads_mappable"] == 48
    for suffix in MESH_MAP_SUFFIXES:
        with open(out1 + suffix) as a, open(out + suffix) as b:
            assert a.read() == b.read(), suffix


def test_mesh_with_more_ranks_than_cards_raises(mesh_mini, tmp_path):
    from metamaps_tpu_torch.cli import main as port_cli_main

    _, argv, _ = mesh_mini
    n = torch.cuda.device_count() + 1
    out = str(tmp_path / "mesh")
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA devices"):
        port_cli_main(argv + ["--output", out, "--mesh", f"shard={n},data=1"])
    assert not os.path.exists(out)


def test_sharded_em_on_one_card_writes_numpy_bytes(mesh_mini, tmp_path):
    """The sharded EM on four ranks of cuda:0 writes the host EM's bytes in
    all seven .EM* files."""
    from metamaps_tpu_torch.engine.em import do_em

    db, _, out1 = mesh_mini
    outs = {}
    for backend in ("numpy", "sharded"):
        d = tmp_path / backend
        d.mkdir()
        for suffix in MESH_MAP_SUFFIXES:
            shutil.copy(out1 + suffix, d)
        outs[backend] = str(d / "single")
        params = Parameters()
        params.db = db
        params.minimum_reads_for_u = 10000
        do_em(params, outs[backend], em_backend=backend,
              device=["cuda:0"] * 4 if backend == "sharded" else "cpu")
    for suffix in (".EM", ".EM.WIMP", ".EM.reads2Taxon",
                   ".EM.reads2Taxon.krona", ".EM.contigCoverage",
                   ".EM.evidenceUnknownSpecies",
                   ".EM.lengthAndIdentitiesPerMappingUnit"):
        with open(outs["numpy"] + suffix, "rb") as a, \
                open(outs["sharded"] + suffix, "rb") as b:
            want = a.read()
            assert want and b.read() == want, suffix


def test_experiments_on_the_card_writes_the_cpu_store(cuda, tmp_path):
    """A tiny ``experiments`` (full and a two-taxon leave-out) with the
    torch engine and the EM rounds on the card writes the bytes of the same
    run with ``--device cpu`` in every file of its store (the plots aside),
    through the batch sweep kernel."""
    from metamaps_tpu_torch.cli import main as port_cli_main

    from util_db import make_mini_db
    from util_torch import run_in, tree_bytes

    make_mini_db(str(tmp_path / "DB"), np.random.default_rng(777),
                 n_genomes=5, genome_len=30000)
    trees = {}
    for device in ("cpu", "cuda"):
        before = l2_event_sweep_batch.launches
        assert run_in(str(tmp_path / device), port_cli_main, [
            "experiments", "--DB", "../DB", "--store", "store", "--name",
            "exp1", "--nReads", "40", "--holdout", "auto2", "--seed", "3",
            "--meanLength", "4000", "--device", device]) == 0
        assert (l2_event_sweep_batch.launches > before) == (device == "cuda")
        trees[device] = tree_bytes(str(tmp_path / device))
    assert "store/exp1/results.json" in trees["cpu"]
    assert sorted(trees["cuda"]) == sorted(trees["cpu"])
    for name, want in trees["cpu"].items():
        assert trees["cuda"][name] == want, name
