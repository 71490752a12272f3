"""Ablation of the lockstep L2 event sweep: a hand-written CUDA kernel and
its plain version.

Counterpart: ``kern`` in ``make(mode)``, ``profiling/pallas_sweep_parts.py``,
which times parts of ``_batch_sweep_kernel`` switched on by the letters of
``mode``: ``c`` (C-plane update), ``m`` (M-plane update), ``s`` (shared
count and its running max) and ``f`` (optimum fold). The kernel source,
``metamaps_tpu_torch/csrc/l2_sweep_parts.cu``, states its semantics, which
differ from the main sweep's (a zero sign counts as -1, no ``n_ev`` stop,
only whole 128-event blocks are swept).

:func:`l2_sweep_parts` takes the plain version, :func:`l2_sweep_parts_ref`,
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .l2_sweep import check_sweep_args, launch, load_library

MODE_BITS = {"c": 1, "m": 2, "s": 4, "f": 8}
TPU_BLK = 128  # events per TPU grid step
MAX_SPLITS = 4  # CTAs (one thread block cluster) per candidate


def mode_bits(mode: str) -> int:
    """The kernel's template flags for ``mode``, a string of letters from
    ``cmsf``."""
    if not set(mode) <= set(MODE_BITS):
        raise ValueError(f"mode letters must come from 'cmsf', got {mode!r}")
    return sum(MODE_BITS[ch] for ch in set(mode))


def parts_config(n: int, sp: int, splits: int = None) -> dict:
    """The kernel's launch configuration for ``n`` candidates at width
    ``sp`` on the current card: CTAs per candidate (``splits``, by default
    clamp(SMs // n, 1, 4)), ranks per thread, threads per CTA and dynamic
    shared memory per CTA. Raises ``ValueError`` where ``sp`` is too wide
    for that many CTAs (a CTA holds at most 31 * 32 * 4 ranks)."""
    cfg = (ctypes.c_int * 4)()
    if load_library().l2_sweep_parts_config(n, sp, splits or 0, cfg) != 0:
        raise ValueError(f"sp={sp} is too wide for l2_sweep_parts at "
                         f"{n} candidates, splits={splits}")
    return dict(splits=cfg[0], ranks_per_thread=cfg[1], threads=cfg[2],
                smem=cfg[3])


def l2_sweep_parts(meta, qrank, signinq, rows, sp: int, mode: str,
                   splits: int = None):
    """Run the ablation ``mode`` over every candidate.

    Inputs as :func:`metamaps_tpu_torch.ops.l2_sweep.l2_event_sweep_batch`
    (``meta``'s n_ev column is not read). Returns ``(out, fold, planes)``:
    ``out`` [N, 4] int32 is the running max of the shared count broadcast
    to four columns (what the JAX kernel writes; zeros without ``s``),
    ``fold`` [N, 4] int32 the fold state (best, first, last, prev_row), and
    ``planes`` [N, 2, sp] int32 the final C and M planes, the last two
    written so that the ``f``, ``c`` and ``m`` work stays live. On CUDA
    tensors each candidate's ranks are split over ``splits`` CTAs of one
    cluster (1 to 4; by default as :func:`parts_config` says)."""
    bits = mode_bits(mode)
    check_sweep_args(meta, qrank, signinq, rows, sp)
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must lie in [1, {MAX_SPLITS}], got {splits}")
    if meta.device.type == "cpu":
        return l2_sweep_parts_ref(meta, qrank, signinq, rows, sp, mode)
    n, e2 = qrank.shape
    out = torch.empty((n, 4), dtype=torch.int32, device=meta.device)
    fold = torch.empty_like(out)
    planes = torch.empty((n, 2, sp), dtype=torch.int32, device=meta.device)
    if n == 0:
        return out, fold, planes
    parts_config(n, sp, splits)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    launch("l2_sweep_parts", meta.device, ptr(meta), ptr(qrank), ptr(signinq),
           ptr(rows), ptr(out), ptr(fold), ptr(planes), ctypes.c_int(n),
           ctypes.c_int(e2), ctypes.c_int(sp), ctypes.c_int(splits or 0),
           ctypes.c_int(bits))
    l2_sweep_parts.launches += 1
    return out, fold, planes


l2_sweep_parts.launches = 0  # kernel launches since the last reset


def l2_sweep_parts_ref(meta, qrank, signinq, rows, sp: int, mode: str):
    """Plain PyTorch version of :func:`l2_sweep_parts`: a Python loop over
    the swept event columns with the [N, sp] planes updated in vectorised
    steps, following ``kern`` line by line. Returns ``(out, fold,
    planes)`` as the kernel does."""
    mode_bits(mode)
    dev = meta.device
    n, e2 = qrank.shape
    m64 = meta.to(torch.int64)
    s, row_lo, row_hi = m64[:, 0:1], m64[:, 1], m64[:, 2]
    lin = torch.arange(sp, device=dev)[None, :]
    c = torch.zeros((n, sp), dtype=torch.int64, device=dev)
    m = torch.zeros_like(c)
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    best, first, last, prev, shared = (torch.zeros_like(acc) for _ in range(5))
    for e in range(e2 // TPU_BLK * TPU_BLK):
        if e % TPU_BLK == 0:  # the TPU kernel reseeds both from its scratch
            acc = torch.maximum(acc, best)
            best = acc
        qr = qrank[:, e].to(torch.int64)[:, None]
        si = signinq[:, e].to(torch.int64)
        inq = ((si == 2) | (si == -2))[:, None]
        sign = torch.where(si > 0, 1, -1)[:, None]
        if "f" in mode:
            row = rows[:, e].to(torch.int64)
            seg_a = torch.maximum(prev, row_lo)
            seg_b = torch.minimum(row - 1, row_hi)
            nonempty = seg_a <= seg_b
            better = nonempty & (shared > best)
            equal = nonempty & (shared == best) & (best > 0)
            first = torch.where(better, seg_a, first)
            last = torch.where(better | equal, seg_b, last)
            best = torch.where(better, shared, best)
            prev = torch.maximum(prev, row)
        if "c" in mode:
            c += torch.where(~inq & (lin >= qr), sign, 0)
        if "m" in mode:
            m += torch.where(inq & (lin == qr), sign, 0)
        if "s" in mode:
            shared = ((m > 0) & (lin + c < s)).sum(dim=1)
            acc = torch.maximum(acc, shared)
    out = acc[:, None].expand(n, 4).to(torch.int32).contiguous()
    fold = torch.stack([best, first, last, prev], dim=1).to(torch.int32)
    return out, fold, torch.stack([c, m], dim=1).to(torch.int32)
