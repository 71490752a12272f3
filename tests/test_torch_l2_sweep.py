"""Port L2 (setup, sweep, finish) vs the JAX package's Pallas path.

- the plain sweep ``l2_event_sweep_ref`` (what the CUDA kernel is held to on
  the card) against ``l2_event_sweep_batch(..., interpret=True)`` on event
  streams from real candidate setups and on random contract-conforming
  streams, including a non-zero-sign event at row INT32_MAX;
- the same plain sweep against ``l2_event_sweep_rb`` and ``l2_event_sweep``
  in interpret mode, the two other Pallas kernels of that contract;
- the ablation's plain version ``l2_sweep_parts_ref`` against ``kern`` of
  ``profiling/pallas_sweep_parts.py`` in interpret mode;
- the full [6, K] L2 output of ``l2_gather`` against ``batch_l2_gather`` on
  the Pallas-interpret path, for the clean, noisy, adversarial and revcomp
  reads of tests/test_l2_pallas.py.

All values are int32 and must be exactly equal."""
import ast
import dataclasses
import os
from functools import partial

import jax
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
from metamaps_tpu.ops import l2_pallas
from metamaps_tpu.ops.l2_pallas import l2_event_sweep_batch
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.ops.l2 import l2_gather, round_up
from metamaps_tpu_torch.ops.l2_setup import l2_setup
from metamaps_tpu_torch.ops.l2_sweep import (
    I32_MAX,
    l2_event_sweep,
    l2_event_sweep_batch as port_sweep_batch,
    l2_event_sweep_rb,
    l2_event_sweep_ref,
    random_event_streams,
)
from metamaps_tpu_torch.ops.l2_sweep_parts import (
    l2_sweep_parts,
    l2_sweep_parts_ref,
)
from metamaps_tpu_torch.ops.tables import device_tables
from metamaps_tpu_torch.ops.winnow import winnow_np

from util_sim import random_genome, revcomp, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

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
    before = port_sweep_batch.launches
    np.testing.assert_array_equal(port_sweep_batch(*args, sp).numpy(), want)
    assert port_sweep_batch.launches == before


def test_l2_gather_matches_batch_l2_gather_pallas(slab):
    ds, tables, jax_args, port_args = slab
    want = np.asarray(batch_l2_gather(CFG_PALLAS, ds, *jax_args))
    got = l2_gather(tables, *port_args, k=16, w=16, range_max=CFG.range_max,
                    sketch_cols=CFG.sketch_max).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[0] > 0).sum() >= 13  # every read scored somewhere
    assert (want[5] > 0).any() and (want[5] < 0).any()  # both strands vote


def _random_streams(seed, n, e2, sp):
    return random_event_streams(np.random.default_rng(seed), n, e2, sp - 1)


def test_plain_sweep_matches_rb_interpret():
    """One shape only: the row-block kernel's interpret-mode compile takes
    tens of seconds. N = 21 leaves a partial row block of 8; E2 = 300 pads
    to three 128-event blocks."""
    sp = 256
    arrs = _random_streams(6, 21, 300, sp)
    want = np.asarray(l2_pallas.l2_event_sweep_rb(
        *map(jnp.asarray, arrs), sp=sp, interpret=True))
    args = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_array_equal(l2_event_sweep_ref(*args, sp).numpy(), want)
    before = l2_event_sweep_rb.launches
    np.testing.assert_array_equal(l2_event_sweep_rb(*args, sp).numpy(), want)
    assert l2_event_sweep_rb.launches == before
    assert (want[:, 0] > 0).sum() > 5


@pytest.mark.parametrize("s_pad", [1024, 2048])
def test_plain_sweep_matches_eager_interpret(s_pad):
    """The eager kernel scores [row_e, row_next - 1] after each event; the
    plain version closes segments lazily. Both must agree, including on the
    non-zero-sign event at row INT32_MAX past n_ev, and where row_hi is
    INT32_MAX, so that the JAX kernel's row_hi + 1 wraps in int32."""
    arrs = _random_streams(s_pad, 33, 200, s_pad)
    arrs[0][::4, 2] = I32_MAX
    want = np.asarray(l2_pallas.l2_event_sweep(
        *map(jnp.asarray, arrs), s_pad=s_pad, interpret=True))
    args = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_array_equal(l2_event_sweep_ref(*args, s_pad).numpy(),
                                  want)
    before = l2_event_sweep.launches
    np.testing.assert_array_equal(l2_event_sweep(*args, s_pad).numpy(), want)
    assert l2_event_sweep.launches == before
    assert (want[:, 0] > 0).sum() >= 5


def test_sweep_wrappers_check_widths():
    arrs = [torch.from_numpy(a) for a in _random_streams(1, 4, 16, 1024)]
    with pytest.raises(ValueError, match="multiple of 1024"):
        l2_event_sweep(*arrs, 1152)
    with pytest.raises(ValueError, match="multiple of 128"):
        l2_event_sweep_rb(*arrs, 1000)
    with pytest.raises(ValueError, match="mode letters"):
        l2_sweep_parts(*arrs, 1024, "cmx")


def _parts_inputs(seed, n, e2, sp, row_span):
    """The ablation script's generator (profiling/pallas_sweep_parts.py:
    ranks below 1024, signs in {+-1, +-2}, sorted rows, s = 900), at a
    small size, plus zero signs, which the ablation counts as -1."""
    rng = np.random.default_rng(seed)
    qrank = rng.integers(0, min(1024, sp - 1), (n, e2), dtype=np.int32)
    signinq = rng.choice([1, -1, 2, -2, 0], (n, e2)).astype(np.int32)
    rows = np.sort(rng.integers(0, row_span, (n, e2)), axis=1).astype(np.int32)
    s = rng.integers(sp // 4, sp, n)
    meta = np.stack([s, np.zeros(n), np.full(n, row_span - 1),
                     np.full(n, e2)], axis=1).astype(np.int32)
    return meta, qrank, signinq, rows


def _pallas_parts(mode, n, sp, e2):
    """``make(mode)`` from profiling/pallas_sweep_parts.py, where it is
    nested in ``main``: its source, executed with the script's free names
    bound at a small size and ``pallas_call`` in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "profiling", "pallas_sweep_parts.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    make = next(node for node in main.body
                if isinstance(node, ast.FunctionDef) and node.name == "make")

    class InterpretPl:
        def __getattr__(self, name):
            return getattr(pl, name)

        pallas_call = staticmethod(partial(pl.pallas_call, interpret=True))

    env = dict(jax=jax, jnp=jnp, pl=InterpretPl(), pltpu=pltpu, N=n, SP=sp,
               E2=e2, BLK=128)
    exec(compile(ast.Module(body=[make], type_ignores=[]), path, "exec"), env)
    return jax.jit(env["make"](mode))


@pytest.mark.parametrize("mode", ["cms", "cmsf"])
def test_plain_parts_matches_pallas_interpret(mode):
    """E2 = 3 * 128 + 45: the 45-event tail is never swept."""
    n, sp, e2 = 8, 256, 3 * 128 + 45
    arrs = _parts_inputs(3, n, e2, sp, row_span=900)
    want = np.asarray(_pallas_parts(mode, n, sp, e2)(*map(jnp.asarray, arrs)))
    args = [torch.from_numpy(a) for a in arrs]
    out = l2_sweep_parts_ref(*args, sp, mode)[0]
    np.testing.assert_array_equal(out.numpy(), want)
    assert (want[:, 0] > 0).all()
    before = l2_sweep_parts.launches
    np.testing.assert_array_equal(l2_sweep_parts(*args, sp, mode)[0].numpy(),
                                  want)
    assert l2_sweep_parts.launches == before


def test_parts_modes_cms_and_cmsf_agree():
    """The fold never raises best above the running max of shared, so the
    f work cannot change the ablation's output: cms and cmsf write the same.
    A mode without s writes zeros."""
    for seed in range(3):
        args = [torch.from_numpy(a) for a in
                _parts_inputs(seed, 16, 700, 384, row_span=300 + 200 * seed)]
        cms, fold_cms, _ = l2_sweep_parts_ref(*args, 384, "cms")
        cmsf, fold_cmsf, _ = l2_sweep_parts_ref(*args, 384, "cmsf")
        assert torch.equal(cms, cmsf)
        assert (cms[:, 0] > 0).all()
        assert (fold_cmsf[:, 0] <= cmsf[:, 0]).all()
        assert (fold_cmsf[:, 3] > 0).all() and (fold_cms[:, 3] == 0).all()
        assert not l2_sweep_parts_ref(*args, 384, "cmf")[0].any()


def test_sweep_bench_runs_on_cpu():
    """The bench's code path at tiny shapes on the CPU, where the wrappers
    take their plain versions; and its bound on known counts."""
    from metamaps_tpu_torch.profiling import sweep_bench

    res = sweep_bench.run("cpu", reps=1, log=lambda m: None,
                          scenarios=(("tiny", 12, 96, 128, 9, 0.5),),
                          paired=(("tiny-paired", 10, 96, 128, 0.0),
                                  ("tiny-mixed", 10, 96, 128, 0.3)),
                          parts_shape=(4, 256, 300))
    row = res["scenarios"][0]
    assert row["equal"] and row["scored"] > 0 and row["E2"] == 192
    paired, mixed = res["scenarios"][1:]
    assert paired["equal"] and mixed["equal"] and paired["E2"] == 96
    # events per mode: setup-shaped streams never leave incremental mode
    assert paired["recount_events"] == 0 < paired["incremental_events"]
    assert mixed["recount_events"] > 0 and row["recount_events"] > 0
    assert [p["mode"] for p in res["parts"]] == ["c", "cm", "cms", "cmsf"]
    # each ablation mode's bound counts its own operations per plane element
    ops = {p["mode"]: p["bound_ms"] for p in res["parts"]}
    assert ops["cm"] == pytest.approx(2 * ops["c"], rel=1e-12)
    assert ops["cms"] == ops["cmsf"] == pytest.approx(3 * ops["c"], rel=1e-12)
    assert res["parts"][0]["bound_by"] == "operations"
    # the bound counts the swept events and, per candidate, the ranks up to
    # its highest in-query rank among them: 1280 and 640 here (the rank
    # 2000 lies past candidate 0's n_ev; 1500 is a ref-only event's)
    meta = np.array([[0, 0, 0, 100], [0, 0, 0, 5000]], np.int32)
    qrank = np.zeros((2, 1000), np.int32)
    signinq = np.zeros((2, 1000), np.int32)
    for n, e, q, si in ((0, 5, 1279, 2), (0, 500, 2000, -2), (1, 10, 639, -2),
                        (1, 20, 1500, 1)):
        qrank[n, e], signinq[n, e] = q, si
    ms, by, counts = sweep_bench.sweep_bound(meta, qrank, signinq, 1980.0)
    assert counts["swept_events"] == 1100 and by == "operations"
    assert counts["max_width"] == 1280
    assert counts["bytes"] == 2 * 16 + 3 * 1100 * 4 + 2 * 16
    ops = 3 * (100 * 1280 + 1000 * 640)
    assert counts["ops"] == ops
    assert abs(ms - ops / (132 * 64 * 1980e6) * 1e3) < 1e-12
    # a fixed count of swept events for every candidate (the ablation's)
    _, _, fixed = sweep_bench.sweep_bound(meta, qrank, signinq, 1980.0,
                                          swept=768, outputs=2)
    assert fixed["swept_events"] == 1536
    assert fixed["ops"] == 3 * 768 * (2001 + 640)
    assert fixed["bytes"] == 2 * 16 + 3 * 1536 * 4 + 2 * 2 * 16
