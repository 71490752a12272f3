"""Port L2 (setup, sweep, finish) vs the JAX package's Pallas path.

- the plain sweep ``l2_event_sweep_ref`` (what the CUDA kernel is held to on
  the card) against ``l2_event_sweep_batch(..., interpret=True)`` on event
  streams from real candidate setups and on random contract-conforming
  streams, including a non-zero-sign event at row INT32_MAX;
- the full [6, K] L2 output of ``l2_gather`` against ``batch_l2_gather`` on
  the Pallas-interpret path, for the clean, noisy, adversarial and revcomp
  reads of tests/test_l2_pallas.py.

All values are int32 and must be exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamaps_tpu.engine.mapper_jax import _minhits_table
from metamaps_tpu.ops.batch_map import (
    DeviceShard,
    MapKernelConfig,
    batch_l1,
    batch_l2_gather,
    batch_lookup,
    batch_sketch,
)
from metamaps_tpu.ops.l2_pallas import l2_event_sweep_batch
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.ops.l2 import l2_gather, round_up
from metamaps_tpu_torch.ops.l2_setup import l2_setup
from metamaps_tpu_torch.ops.l2_sweep import (
    I32_MAX,
    l2_event_sweep,
    l2_event_sweep_ref,
    random_event_streams,
)
from metamaps_tpu_torch.ops.tables import device_tables
from metamaps_tpu_torch.ops.winnow import winnow_np

from util_sim import random_genome, revcomp, sample_reads

CFG = MapKernelConfig.for_read_len(4096, 16, 16, l2_impl="scatter")
CFG_PALLAS = dataclasses.replace(CFG, l2_impl="pallas", l2_interpret=True)


@pytest.fixture(scope="module")
def slab():
    """The genomes of tests/test_l2_pallas.py and its read cases, sketched,
    looked up and L1-expanded by the JAX package: one flat candidate slab."""
    rng = np.random.default_rng(2024)
    genomes = [random_genome(rng, 25000) for _ in range(3)]
    shard = SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        h, p, s = winnow_np(g, 16, 16)
        parts.append((h, p, s, i))
        shard.contig_names.append(f"C{i}")
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    g0, g1 = genomes[0], genomes[1]
    seqs = [r[0] for r in sample_reads(rng, genomes, 4, min_len=2500,
                                       max_len=3800, sub=0.0)]  # clean
    seqs += [r[0] for r in sample_reads(rng, genomes, 4, min_len=2500,
                                        max_len=3800, sub=0.08)]  # noisy
    seqs += [
        np.tile(g0[1000:1350], 10),  # tandem repeats (chain events)
        revcomp(g0[5000:8500]),  # exact revcomp
        np.concatenate([g0[2000:3800], g0[20000:21800]]),  # chimera
        np.tile(g1[9000:9360], 9),
        np.concatenate([g1[1000:2600], revcomp(g1[15000:16600])]),
    ]
    B = len(seqs)
    reads = np.full((B, 4096), ord("A"), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, sq in enumerate(seqs):
        reads[i, : len(sq)] = sq
        lens[i] = len(sq)
    ds = DeviceShard.from_host(shard)
    mh = jnp.asarray(_minhits_table(CFG.sketch_max, 16, 80.0))
    qh, qs, ss, _ = batch_sketch(CFG, jnp.asarray(reads), jnp.asarray(lens))
    _, _, _, qk = batch_lookup(CFG, ds, qh)
    cs, cst, cen, _, _ = batch_l1(CFG, ds, qh, ss, jnp.asarray(lens), mh)
    rows = np.repeat(np.arange(B), CFG.cands_max).astype(np.int32)
    jax_args = (qh, qs, ss, jnp.asarray(lens), jnp.asarray(rows),
                cs.reshape(-1), cst.reshape(-1), cen.reshape(-1), qk)
    t64 = lambda x: torch.from_numpy(np.asarray(x).astype(np.int64))
    port_args = (t64(qk), t64(qs), t64(ss), t64(lens), t64(rows),
                 t64(cs).reshape(-1), t64(cst).reshape(-1),
                 t64(cen).reshape(-1))
    return ds, device_tables(shard, "cpu"), jax_args, port_args


def test_plain_sweep_matches_pallas_interpret(slab):
    """One Pallas call over real setup streams followed by random ones."""
    _, tables, _, (qk, _, ss, lens, rows, cs, cst, cen) = slab
    st = l2_setup(tables, qk[rows], ss[rows], lens[rows], cs, cst, cen,
                  16, 16, CFG.range_max, CFG.sketch_max)
    assert int(st.meta[:, 3].max()) > 0
    # the last window occurrence's removal sits at row INT32_MAX, past n_ev
    assert ((st.rows == I32_MAX) & (st.signinq != 0)).any()
    sp = round_up(CFG.sketch_max + 1, 128)
    e2 = st.rows.shape[1]
    rnd = random_event_streams(np.random.default_rng(5), 64, 300, sp - 1)
    pad = [np.full((64, e2), fill, np.int32) for fill in (0, 0, I32_MAX)]
    for p, a in zip(pad, rnd[1:]):
        p[:, : a.shape[1]] = a
    meta = np.concatenate([st.meta.numpy(), rnd[0]])
    qrank, signinq, rows_ev = (
        np.concatenate([getattr(st, f).numpy(), p])
        for f, p in zip(("qrank", "signinq", "rows"), pad))
    want = np.asarray(l2_event_sweep_batch(
        jnp.asarray(meta), jnp.asarray(qrank), jnp.asarray(signinq),
        jnp.asarray(rows_ev), sp=sp, interpret=True))
    args = [torch.from_numpy(a) for a in (meta, qrank, signinq, rows_ev)]
    got = l2_event_sweep_ref(*args, sp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] > 0).sum() > 20
    # on CPU tensors the wrapper takes the plain version, without launching
    before = l2_event_sweep.launches
    np.testing.assert_array_equal(l2_event_sweep(*args, sp).numpy(), want)
    assert l2_event_sweep.launches == before


def test_l2_gather_matches_batch_l2_gather_pallas(slab):
    ds, tables, jax_args, port_args = slab
    want = np.asarray(batch_l2_gather(CFG_PALLAS, ds, *jax_args))
    got = l2_gather(tables, *port_args, k=16, w=16, range_max=CFG.range_max,
                    sketch_cols=CFG.sketch_max).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[0] > 0).sum() >= 13  # every read scored somewhere
    assert (want[5] > 0).any() and (want[5] < 0).any()  # both strands vote
