"""The L2 sweep kernels against each other at the JAX engine's slab shapes.

Counterpart of ``profiling/sweep_rb_bench.py`` (row-block vs lockstep sweep)
and ``profiling/pallas_sweep_parts.py`` (the sweep's ablation):

- six scenarios with the generator and seed of ``sweep_rb_bench.py``
  (K 112 / 224 candidates, R 1792, SP 1152, 112 / 56 / 8 / 224 real
  candidates, events at 100 % or 40 % of E2 = 2 R), whose random signs keep
  the kernels mostly in their recount mode, and three setup-shaped ones
  (``ops/l2_sweep.py:paired_event_streams`` at K 112 / 224, E2 3584, SP
  1152): ``paired-full`` and ``paired-big``, where every event takes the
  O(1) mode, and ``mixed``, where 4 % of the ref-only occurrences remove
  before they add. ``l2_event_sweep_batch``, ``l2_event_sweep_rb`` and
  ``l2_event_sweep`` (planes of ``s_pad`` 2048, the multiple of 1024 above
  SP) are timed and must give the same outputs; each row reports its
  events in each mode (:func:`sweep_routes`) and the bound the three
  kernels share on its inputs (:func:`sweep_bound`);
- the ablation modes ``c``, ``cm``, ``cms`` and ``cmsf`` at N 56, SP 1152,
  E2 4480 with the ablation script's seed 0, each timed beside its bound;
  ``cms`` and ``cmsf`` must give the same output, and every mode with a
  plane's letter the same plane.

On a CUDA device only the kernels run (CUDA-event timings); on the CPU the
wrappers take their plain versions (host-clock timings), which is for
tests at small shapes only.

    python -m metamaps_tpu_torch.profiling.sweep_bench            # cuda:0
    python -m metamaps_tpu_torch.profiling.sweep_bench --reps 20
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.l2_sweep import (
    l2_event_sweep,
    l2_event_sweep_batch,
    l2_event_sweep_rb,
    paired_event_streams,
)
from ..ops.l2_sweep_parts import TPU_BLK, l2_sweep_parts, parts_config

# (name, K candidates, R, SP, real candidates, event fraction), in the order
# of sweep_rb_bench.py, which draws them all from one generator
SCENARIOS = (
    ("full", 112, 1792, 1152, 112, 1.0),
    ("half-pad", 112, 1792, 1152, 56, 1.0),
    ("sparse", 112, 1792, 1152, 8, 1.0),
    ("short-ev", 112, 1792, 1152, 112, 0.4),
    ("big-full", 224, 1792, 1152, 224, 1.0),
    ("big-half", 224, 1792, 1152, 112, 1.0),
)
SCENARIO_SEED = 5
# setup-shaped scenarios: (name, K candidates, E2, SP, flip), drawn from a
# generator of their own, so that the six above keep their streams
PAIRED_SCENARIOS = (
    ("paired-full", 112, 3584, 1152, 0.0),
    ("paired-big", 224, 3584, 1152, 0.0),
    ("mixed", 112, 3584, 1152, 0.04),
)
PAIRED_SEED = 6
EAGER_S_PAD = 2048
PARTS_SHAPE = (56, 1152, 4480)  # N, SP, E2 of pallas_sweep_parts.py
PARTS_SEED = 0
PARTS_MODES = ("c", "cm", "cms", "cmsf")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SM_CLOCK_MHZ = 1980.0  # H100 SXM's highest SM clock (nvidia-smi clocks.max.sm)
SMS, INT32_LANES = 132, 64  # H100 SXM: SMs, INT32 lanes per SM
OPS_PER_PLANE_ELEMENT = 3  # suffix add, one-hot test, count per rank and event
# an event while the count has its prefix form (csrc/l2_sweep.cu): the lazy
# close (segment test, count against best, three selects: 4), the plane's
# add (1), the step test of the prefix end J and its move (2), the count's
# add (1)
OPS_PER_INCREMENTAL_EVENT = 8


def scenario_streams(rng, K, R, SP, n_real, ev_frac):
    """One scenario's event streams, drawn as ``sweep_rb_bench.py`` draws
    them (numpy int32: meta, qrank, signinq, rows)."""
    E2 = 2 * R
    meta = np.zeros((K, 4), np.int32)
    qrank = np.zeros((K, E2), np.int32)
    signinq = np.zeros((K, E2), np.int32)
    rows = np.full((K, E2), 2**31 - 1, np.int32)
    for i in range(n_real):
        ne = int(E2 * ev_frac)
        rows[i, :ne] = np.sort(rng.integers(0, 500000, ne)).astype(np.int32)
        qrank[i, :ne] = rng.integers(0, SP - 1, ne)
        signinq[i, :ne] = rng.choice([1, -1, 2, -2], ne)
        meta[i] = (900, 0, 500000, ne)
    return meta, qrank, signinq, rows


def bench_inputs(scenarios=SCENARIOS, paired=PAIRED_SCENARIOS, only=None):
    """The scenarios' streams in order, as numpy int32 arrays: (name,
    [meta, qrank, signinq, rows], SP, the scenario's parameters). Each
    generator draws every scenario of its list; ``only`` (names) picks
    which are returned, with the same streams as in a full run."""
    rng = np.random.default_rng(SCENARIO_SEED)
    for name, K, R, SP, n_real, ev_frac in scenarios:
        host = list(scenario_streams(rng, K, R, SP, n_real, ev_frac))
        if only is None or name in only:
            yield (name, host, SP,
                   dict(K=K, E2=2 * R, real=n_real, ev_frac=ev_frac))
    rng = np.random.default_rng(PAIRED_SEED)
    for name, K, E2, SP, flip in paired:
        host = list(paired_event_streams(rng, K, E2, SP - 1, flip=flip))
        if only is None or name in only:
            yield name, host, SP, dict(K=K, E2=E2, flip=flip)


def parts_streams(N=PARTS_SHAPE[0], SP=PARTS_SHAPE[1], E2=PARTS_SHAPE[2],
                  seed=PARTS_SEED):
    """The ablation's inputs, drawn as ``pallas_sweep_parts.py`` draws them
    (``SP`` is not drawn from; it is the plane width)."""
    rng = np.random.default_rng(seed)
    qrank = rng.integers(0, 1024, (N, E2), dtype=np.int32)
    signinq = rng.choice([1, -1, 2, -2], (N, E2)).astype(np.int32)
    rows = np.sort(rng.integers(0, 3584, (N, E2)), axis=1).astype(np.int32)
    meta = np.stack([np.full(N, 900), np.zeros(N), np.full(N, 3583),
                     np.full(N, E2)], axis=1).astype(np.int32)
    return meta, qrank, signinq, rows


def parts_bound(host, sp: int, mode: str, clock_mhz: float):
    """:func:`sweep_bound` of the ablation ``mode`` on its numpy inputs
    ``host`` (meta, qrank, signinq, rows) at width ``sp``: the whole
    128-event blocks swept, ``out`` and ``fold`` written, and the [N, 2,
    sp] int32 planes."""
    n, e2 = host[1].shape
    return sweep_bound(*host[:3], clock_mhz, swept=e2 // TPU_BLK * TPU_BLK,
                       outputs=2, plane_ops=parts_plane_ops(mode),
                       extra_bytes=n * 2 * sp * 4)


def time_ms(fn, device, reps: int) -> float:
    """Mean milliseconds per call after one warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sweep_routes(meta, qrank, signinq, sp: int):
    """How each candidate's swept events split between the two modes of the
    batch kernel (``csrc/l2_sweep.cu``), on numpy inputs of the sweep's
    contract: an event is in recount mode when, just after it, some query
    rank's ref-only multiplicity r is negative (the count then lacks its
    prefix form), and in incremental mode otherwise. r is replayed per
    (candidate, rank): a ref-only event (sign != 0, |signinq| != 2) at qr <
    sp moves r[max(qr, 0)] by its sign. Returns (incremental [N], recount
    [N]) int64 counts of the swept events (n_ev clamped to [0, E2])."""
    meta, qrank, signinq = map(np.asarray, (meta, qrank, signinq))
    n, e2 = qrank.shape
    n_ev = np.clip(meta[:, 3].astype(np.int64), 0, e2)
    live = np.arange(e2)[None, :] < n_ev[:, None]
    ref = live & (signinq != 0) & (np.abs(signinq) != 2) & (qrank < sp)
    cand, ev = np.nonzero(ref)
    sign = np.sign(signinq[cand, ev]).astype(np.int64)
    key = cand * np.int64(sp) + np.maximum(qrank[cand, ev], 0)
    order = np.argsort(key, kind="stable")  # by (candidate, rank), then event
    key, sign = key[order], sign[order]
    first = np.ones(key.size, bool)  # an event that opens its (candidate, rank)
    first[1:] = key[1:] != key[:-1]
    run = np.cumsum(sign)
    after = run - (run - sign)[first][np.cumsum(first) - 1]  # r just after it
    delta = np.zeros((n, e2), np.int32)  # change of the count of negative ranks
    delta[cand[order], ev[order]] = ((after < 0).astype(np.int32)
                                     - (after - sign < 0))
    neg = np.cumsum(delta, axis=1, dtype=np.int32)
    recount = (live & (neg > 0)).sum(axis=1).astype(np.int64)
    return n_ev - recount, recount


def parts_plane_ops(mode: str) -> int:
    """Operations per plane element and event of an ablation mode: one for
    each of the suffix add (``c``), the one-hot add (``m``) and the count
    (``s``) that it does."""
    return len(set(mode) & set("cms"))


def sweep_bound(meta, qrank, signinq, sm_clock_mhz: float,
                swept=None, outputs: int = 1, sp: int = None,
                plane_ops: int = OPS_PER_PLANE_ELEMENT, extra_bytes: int = 0):
    """The least time the card could take for one sweep on these inputs
    (numpy arrays): the larger of the bytes bound (the swept events and
    ``meta`` read once, ``outputs`` [N, 4] int32 arrays and ``extra_bytes``
    more written once, at 3.35 TB/s) and the operations bound (integer
    operations at the CUDA cores' INT32 rate of 132 SMs x 64 lanes x the SM
    clock).

    The operations count what this data needs, whatever implements it. A
    recount event needs about ``plane_ops`` (3) operations per plane
    element, and only the ranks up to the candidate's highest in-query rank
    among its swept events (the count reads the C plane only where the M
    plane is set).
    Given ``sp``, the inputs are the sweep's (``l2_event_sweep_batch``,
    ``_rb``, ``l2_event_sweep``): an event in incremental mode
    (:func:`sweep_routes`) needs ``OPS_PER_INCREMENTAL_EVENT`` operations
    and only the others a recount. Without ``sp`` (the ablation, whose work
    is the recount's parts by definition) every swept event is a recount.
    Candidate n sweeps ``swept[n]`` events (its own n_ev clamped to E2
    unless ``swept`` gives the counts). Returns (ms, "bytes" or
    "operations", the bounds' inputs), the inputs with ``recount_ms``, the
    bound with every swept event recounted."""
    meta, qrank, signinq = map(np.asarray, (meta, qrank, signinq))
    n, e2 = qrank.shape
    if swept is None:
        swept = meta[:, 3]
    swept = np.clip(np.broadcast_to(np.asarray(swept, np.int64), (n,)), 0, e2)
    live = np.arange(e2)[None, :] < swept[:, None]
    inq = live & (np.abs(signinq) == 2)
    width = np.where(inq.any(axis=1),
                     np.where(inq, qrank.astype(np.int64) + 1, 0).max(axis=1), 0)
    if sp is None:
        incremental, recount = np.zeros(n, np.int64), swept
    else:
        incremental, recount = sweep_routes(meta, qrank, signinq, sp)
    swept_events = int(swept.sum())
    n_bytes = (n * 4 * 4 + 3 * swept_events * 4 + outputs * n * 4 * 4
               + extra_bytes)
    recount_ops = plane_ops * int((swept * width).sum())
    n_ops = (OPS_PER_INCREMENTAL_EVENT * int(incremental.sum())
             + plane_ops * int((recount * width).sum()))
    rate = SMS * INT32_LANES * sm_clock_mhz * 1e6
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / rate * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, dict(
        bytes=n_bytes, ops=n_ops, swept_events=swept_events,
        max_width=int(width.max()) if n else 0,
        incremental_events=int(incremental.sum()),
        recount_events=int(recount.sum()),
        recount_ops=recount_ops,
        recount_ms=max(bytes_ms, recount_ops / rate * 1e3))


def run(device, reps: int = 10, scenarios=SCENARIOS,
        paired=PAIRED_SCENARIOS, parts_shape=PARTS_SHAPE, log=print,
        clock_mhz: float = SM_CLOCK_MHZ) -> dict:
    """Time and cross-check the sweep kernels on ``device``; the bounds
    take the SM clock ``clock_mhz``. Returns the scenarios' results and the
    ablation's, each with its inputs (as tensors on ``device``) for callers
    that compare further."""
    device = torch.device(device)
    results = {"scenarios": [], "parts": []}
    for name, host, SP, params in bench_inputs(scenarios, paired):
        arrs = [torch.from_numpy(a).to(device) for a in host]
        variants = {
            "batch": lambda: l2_event_sweep_batch(*arrs, SP),
            "rb": lambda: l2_event_sweep_rb(*arrs, SP),
            "eager": lambda: l2_event_sweep(*arrs, EAGER_S_PAD),
        }
        outs = {k: fn() for k, fn in variants.items()}
        equal = all(torch.equal(outs["batch"], o) for o in outs.values())
        ms = {k: time_ms(fn, device, reps) for k, fn in variants.items()}
        bound_ms, bound_by, counts = sweep_bound(*host[:3], clock_mhz, sp=SP)
        row = dict(scenario=name, sp=SP, s_pad=EAGER_S_PAD, **params, ms=ms,
                   equal=equal, scored=int((outs["batch"][:, 0] > 0).sum()),
                   incremental_events=counts["incremental_events"],
                   recount_events=counts["recount_events"],
                   bound_ms=bound_ms, bound_by=bound_by)
        log(json.dumps(row))
        row.update(inputs=arrs, out=outs["batch"])
        results["scenarios"].append(row)
        if not equal:
            raise AssertionError(f"sweep kernels disagree on scenario {name}")
    N, SP, E2 = parts_shape
    host = parts_streams(N, SP, E2, PARTS_SEED)
    arrs = [torch.from_numpy(a).to(device) for a in host]
    outs = {}
    for mode in PARTS_MODES:
        outs[mode] = l2_sweep_parts(*arrs, SP, mode)
        ms = time_ms(lambda: l2_sweep_parts(*arrs, SP, mode), device, reps)
        bound_ms, bound_by, _ = parts_bound(host, SP, mode, clock_mhz)
        row = dict(mode=mode, N=N, E2=E2, sp=SP, ms=ms, bound_ms=bound_ms,
                   bound_by=bound_by, acc_max=int(outs[mode][0][:, 0].max()))
        if device.type == "cuda":
            row.update(parts_config(N, SP))
        log(json.dumps(row))
        results["parts"].append(dict(row, inputs=arrs, out=outs[mode]))
    if not torch.equal(outs["cms"][0], outs["cmsf"][0]):
        raise AssertionError("ablation modes cms and cmsf disagree")
    for mode in PARTS_MODES:  # each plane is the same in every mode with it
        for k, letter in enumerate("cm"):
            if letter in mode and not torch.equal(outs[mode][2][:, k],
                                                  outs["cmsf"][2][:, k]):
                raise AssertionError(f"ablation mode {mode}: {letter} plane")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("sweep_bench: no CUDA device", file=sys.stderr)
        return 1
    if device.type == "cuda":
        print(json.dumps({"device": torch.cuda.get_device_name(device)}))
    run(device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
