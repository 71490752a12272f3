"""Tests of the port that need an NVIDIA card; they skip on the CPU.

This file imports no JAX, so that it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.) Each
sweep kernel must equal its plain version bit for bit: both are exact int32.
"""
import numpy as np
import pytest
import torch

from metamaps_tpu_torch.engine import mapper_oracle
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.ops.l2_sweep import (
    l2_event_sweep,
    l2_event_sweep_batch,
    l2_event_sweep_rb,
    l2_event_sweep_ref,
    paired_event_streams,
    random_event_streams,
)
from metamaps_tpu_torch.ops.l2_sweep_parts import (
    l2_sweep_parts,
    l2_sweep_parts_ref,
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


@pytest.mark.parametrize("mode", ["cms", "cmsf", "cmf", "s"])
def test_parts_kernel_equals_plain(cuda, mode):
    """Output and fold state, at a small ablation shape (E2 = 3 * 128 + 45:
    the tail is not swept)."""
    cpu = [torch.from_numpy(a) for a in parts_streams(12, 1152, 429, seed=4)]
    before = l2_sweep_parts.launches
    got = l2_sweep_parts(*[a.to(cuda) for a in cpu], 1152, mode)
    torch.cuda.synchronize()
    assert l2_sweep_parts.launches == before + 1
    want = l2_sweep_parts_ref(*cpu, 1152, mode)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_variant_wrappers_reject_bad_widths(cuda):
    arrs = [torch.from_numpy(a).to(cuda) for a in
            random_event_streams(np.random.default_rng(5), 4, 16, 100)]
    with pytest.raises(ValueError, match="shared memory"):
        l2_event_sweep_rb(*arrs, 3712)  # 64 * 3712 B > 227 KB
    with pytest.raises(ValueError, match="multiple of 1024"):
        l2_event_sweep(*arrs, 1152)
    with pytest.raises(ValueError, match="mode letters"):
        l2_sweep_parts(*arrs, 1152, "cmq")
    with pytest.raises(TypeError):
        l2_sweep_parts(arrs[0].long(), *arrs[1:], 1152, "cms")


@pytest.mark.parametrize("name", ["batch", "rb", "eager", "parts"])
def test_empty_input_launches_nothing(cuda, name):
    """N = 0 candidates: an empty result, no kernel launched, no count."""
    wrapper, width = {
        "batch": (l2_event_sweep_batch, (1152,)),
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
    for out in got if isinstance(got, tuple) else (got,):
        assert out.shape == (0, 4)
