"""The least time the card could take for one L2 sweep on given inputs.

Frozen copy of ``sweep_routes`` and ``sweep_bound`` (with their constants)
from ``metamaps_tpu_torch/profiling/sweep_bench.py``: they count the bytes
and integer operations that these inputs need, whatever implements them.
The roofline metric divides this bound by the sweep kernels' device time.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SM_CLOCK_MHZ = 1980.0  # H100 SXM's highest SM clock (nvidia-smi clocks.max.sm)
SMS, INT32_LANES = 132, 64  # H100 SXM: SMs, INT32 lanes per SM
OPS_PER_PLANE_ELEMENT = 3  # suffix add, one-hot test, count per rank and event
# an event while the count has its prefix form (csrc/l2_sweep.cu): the lazy
# close (segment test, count against best, three selects: 4), the plane's
# add (1), the step test of the prefix end J and its move (2), the count's
# add (1)
OPS_PER_INCREMENTAL_EVENT = 8


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
