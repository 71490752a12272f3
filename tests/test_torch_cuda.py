"""Tests of the port that need an NVIDIA card; they skip on the CPU.

This file imports no JAX, so that it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.) The
sweep kernel must equal its plain version bit for bit: both are exact int32.
"""
import numpy as np
import pytest
import torch

from metamaps_tpu.params import Parameters
from metamaps_tpu_torch.engine import mapper_oracle
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.ops.l2_sweep import (
    l2_event_sweep,
    l2_event_sweep_ref,
    random_event_streams,
)
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
    before = l2_event_sweep.launches
    got = l2_event_sweep(*dev, sp)
    torch.cuda.synchronize()
    assert l2_event_sweep.launches == before + 1
    want = l2_event_sweep_ref(*cpu, sp)
    assert torch.equal(got.cpu(), want)


def test_sweep_wrapper_rejects_bad_input(cuda):
    arrs = [torch.from_numpy(a).to(cuda) for a in
            random_event_streams(np.random.default_rng(5), 4, 16, 100)]
    with pytest.raises(TypeError):
        l2_event_sweep(arrs[0].long(), *arrs[1:], 128)
    with pytest.raises(ValueError):
        l2_event_sweep(*arrs, 100)
    with pytest.raises(ValueError):
        l2_event_sweep(arrs[0].cpu(), *arrs[1:], 128)


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
    before = l2_event_sweep.launches
    got = engine.map_reads(seqs)
    torch.cuda.synchronize()
    assert l2_event_sweep.launches > before
    for i, seq in enumerate(seqs):
        assert got[i] == mapper_oracle.map_read(shard, params, seq), f"read {i}"
