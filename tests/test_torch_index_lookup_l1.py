"""Port index, device tables, lookup and L1 vs the JAX package.

The jax-free ``SketchShard`` build must give the JAX package's arrays
(including the memory-bounded shard cut), a shard saved by the JAX package
must load in the port, and ``lookup`` / ``l1_regions`` must reproduce
``batch_lookup`` / the expansion stage (``map_batch_stage1b``: regions,
overflow flags and occurrence counts). All outputs are integers and must be
exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamaps_tpu.engine import index as jindex
from metamaps_tpu.engine.mapper_jax import _minhits_table
from metamaps_tpu.ops.batch_map import (
    DeviceShard,
    MapKernelConfig,
    batch_lookup,
    batch_sketch,
    map_batch_stage1b,
)
from metamaps_tpu.params import Parameters
from metamaps_tpu_torch.engine import index as tindex
from metamaps_tpu_torch.ops.l1 import l1_regions, minhits_table
from metamaps_tpu_torch.ops.lookup import lookup
from metamaps_tpu_torch.ops.tables import device_tables

from util_sim import random_genome, revcomp, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

SHARD_FIELDS = ("seqid", "wpos", "strand", "hash_pos_order", "hash_sorted",
                "seqid_byhash", "wpos_byhash", "strand_byhash",
                "contig_offsets")
CFG = MapKernelConfig.for_read_len(4096, 16, 16, l2_impl="scatter")
# a hit capacity small enough for the repeat reads below to exceed it
CFG_L1 = dataclasses.replace(CFG, hits_max=1024)


def _write_fasta(path, genomes):
    with open(path, "w") as f:
        for i, g in enumerate(genomes):
            f.write(f">C{i}|kraken:taxid|{1000 + i}|X{i}.1\n")
            f.write(g.tobytes().decode() + "\n")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    rng = np.random.default_rng(2024)
    genomes = [random_genome(rng, 25000) for _ in range(3)]
    # a repeat family planted in every genome: same-hash chains and hash
    # counts above the frequency threshold
    rep = random_genome(rng, 300)
    for g in genomes:
        for pos in rng.integers(0, len(g) - 300, 12):
            g[pos:pos + 300] = rep
    genomes.append(random_genome(rng, 10))  # too short to winnow
    fa = str(root / "ref.fa")
    _write_fasta(fa, genomes)
    params = Parameters(kmer_size=16, window_size=16, min_read_length=1000,
                        percentage_identity=80.0)
    params.ref_sequences = [fa]
    return root, rng, genomes, params, rep


def _shards(module, params, maximum_memory):
    out = []
    module.build_shards(params, maximum_memory, lambda s, n: out.append(s))
    return out


@pytest.mark.parametrize("maximum_memory", [0, 300_000])
def test_shards_equal_jax_package(setup, maximum_memory):
    params = setup[3]
    got = _shards(tindex, params, maximum_memory)
    want = _shards(jindex, params, maximum_memory)
    assert len(got) == len(want) >= (2 if maximum_memory else 1)
    for g, w in zip(got, want):
        assert g.contig_names == w.contig_names
        assert g.contig_lengths == w.contig_lengths
        assert g.freq_threshold == w.freq_threshold
        for f in SHARD_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)


def test_jax_saved_index_loads_in_port(setup):
    root, params = setup[0], setup[3]
    prefix = str(root / "jidx")
    files = jindex.create_index(params, prefix)
    assert tindex.load_index_manifest(prefix) == files
    for f in files:
        g, w = tindex.SketchShard.load(f), jindex.SketchShard.load(f)
        assert g.contig_names == w.contig_names
        assert g.freq_threshold == w.freq_threshold
        for name in SHARD_FIELDS:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert device_tables(g, "cpu").n_minimizers == g.n_minimizers


@pytest.fixture(scope="module")
def batch(setup):
    """One JAX shard, its DeviceShard and port tables, and a read batch with
    its sketch: noisy reads, repeat reads, a revcomp read, an alien, and a
    repeat flanked by alien sequence (more candidate regions than
    cands_max) and a tandem of the repeat (more hits than hits_max)."""
    _, rng, genomes, params, rep = setup
    shard = _shards(jindex, params, 0)[0]
    g = genomes[0]
    seqs = [r[0] for r in sample_reads(rng, genomes[:3], 6, min_len=1500,
                                       max_len=4000, sub=0.06)]
    seqs += [
        np.tile(g[2000:2300], 8),
        revcomp(genomes[1][4000:7000]),
        random_genome(rng, 2500),
        np.concatenate([random_genome(rng, 500), rep[:200],
                        random_genome(rng, 500)]),
        np.tile(rep, 10),
    ]
    reads = np.full((len(seqs), 4096), ord("A"), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = s
        lens[i] = len(s)
    q_hash, _, s_size, _ = batch_sketch(CFG, jnp.asarray(reads),
                                        jnp.asarray(lens))
    return (DeviceShard.from_host(shard), device_tables(shard, "cpu"),
            np.asarray(q_hash), np.asarray(s_size), lens)


def test_lookup_matches_batch_lookup(batch):
    ds, tables, q_hash, _, _ = batch
    want = batch_lookup(CFG, ds, jnp.asarray(q_hash))
    got = lookup(tables, torch.from_numpy(q_hash.astype(np.int64)))
    for name, g, w in zip(("start", "count", "total", "qkey"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


def test_minhits_table_matches_jax_engine():
    np.testing.assert_array_equal(minhits_table(300, 16, 80.0),
                                  _minhits_table(300, 16, 80.0))


def test_l1_matches_batch_l1_expand(batch):
    ds, tables, q_hash, s_size, lens = batch
    B, C = len(lens), CFG.cands_max
    mh = _minhits_table(CFG.sketch_max, 16, 80.0)
    start, count, total, _ = batch_lookup(CFG, ds, jnp.asarray(q_hash))
    want = np.asarray(map_batch_stage1b(
        CFG_L1, ds, jnp.arange(B, dtype=jnp.int32), start, count,
        jnp.asarray(s_size), jnp.asarray(lens), jnp.asarray(mh)))
    reg = l1_regions(
        tables, *(torch.from_numpy(np.asarray(x).astype(np.int64))
                  for x in (start, count, total)),
        torch.from_numpy(s_size.astype(np.int64)), torch.from_numpy(lens),
        torch.from_numpy(mh.astype(np.int64)), CFG_L1.hits_max, C)

    ovf = reg.overflow.numpy()
    np.testing.assert_array_equal(ovf, want[:, 1] > 0)
    assert ovf.any() and not ovf.all()
    n_reg = reg.n_regions.numpy()
    read = reg.read.numpy()
    fields = [reg.seq, reg.start, reg.end, reg.n_occ]
    for r in np.flatnonzero(~ovf):
        assert n_reg[r] == want[r, 0]
        sel = read == r
        for f, col in zip(fields, range(2, 2 + 4 * C, C)):
            got_r = np.zeros(C, np.int64)
            got_r[: n_reg[r]] = f.numpy()[sel]
            want_r = want[r, col:col + C].copy()
            want_r[n_reg[r]:] = 0
            np.testing.assert_array_equal(got_r, want_r, f"read {r}")
    assert n_reg[~ovf].sum() > 0
