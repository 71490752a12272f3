"""Batched read sketch: the sorted unique minimizer hashes of each read.

Counterpart: ``batch_sketch``, ``metamaps_tpu/ops/batch_map.py:909``.

:func:`sketch` takes the plain version, :func:`sketch_ref` (a chain of torch
ops: ``winnow_dense``, a stable sort, a cumsum and two scatters), for CPU
tensors; for CUDA tensors it launches the hand-written kernel
``csrc/sketch.cu`` (one block per read), built into the L2 sweep kernels'
library (``ops/l2_sweep.py`` ``load_library``), and counts the launch in
``sketch.launches``, for every k and w.
"""
from __future__ import annotations

import ctypes

import torch

from .winnow import _POS_BITS, winnow_dense

U32_MAX = 0xFFFFFFFF

#: k-mer positions per tile of the kernel (``TILE``, csrc/sketch.cu)
TILE = 1024
#: the kernel's record buffer in shared memory at most, in records
RB_MAX = 16384
#: dynamic shared memory a block may take, less room for the kernel's
#: static shared memory (227 KB a Hopper block)
SMEM_DYN_MAX = 227 * 1024 - 1024


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def sketch_plan(L: int, k: int, w: int, S: int):
    """The kernel's sizes for reads padded to ``L``: (kcap, rb, spills,
    gring) with the key ring kcap >= TILE + w - 1, the record buffer rb
    (twice S, a power of two in [TILE, RB_MAX], no more than a read's
    windows need, and no more than shared memory holds), whether a read can
    emit more than rb records, so that the launch needs a workspace of B x 2
    x (S + 1) records, and whether the ring is too large for shared memory
    (w above about 15,000), so that it lives in a workspace of B x kcap x 9
    bytes."""
    kcap = _pow2_at_least(TILE + w - 1)
    gring = smem_bytes(kcap, TILE) > SMEM_DYN_MAX
    ring = 0 if gring else kcap
    windows = L - k + 1 - w + 1
    rb = min(max(_pow2_at_least(2 * S), TILE), RB_MAX,
             max(_pow2_at_least(windows), TILE))
    while smem_bytes(ring, rb) > SMEM_DYN_MAX:
        rb //= 2
    return kcap, rb, windows > rb, gring


def smem_bytes(kcap: int, rb: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes``, csrc/sketch.cu):
    a ring's keys and strand bits (``kcap`` 0 for a ring in the workspace),
    a tile's window records, the buffer."""
    return kcap * 9 + TILE * 8 + rb * 8


def _check(reads: torch.Tensor, k: int, w: int):
    n = reads.shape[1] - k + 1
    if n - w + 1 <= 0:
        raise ValueError("padded read length must cover one window")
    if n >= (1 << _POS_BITS):
        raise ValueError("padded read length exceeds the position field")


def sketch(reads: torch.Tensor, read_lens: torch.Tensor, k: int, w: int,
           sketch_max: int, alphabet_size: int = 4):
    """``reads`` uint8 ``[B, L]`` (right-padded), ``read_lens`` ``[B]``.

    Returns ``q_hash`` int64 ``[B, S]`` (ascending unique hashes, padded
    U32_MAX), ``q_strand`` int8 ``[B, S]`` (strand of each hash's first
    occurrence, padded 0), ``sketch_size`` int64 ``[B]`` (clipped to S) and
    ``overflow`` bool ``[B]`` (more than S unique hashes). CUDA tensors
    launch ``csrc/sketch.cu`` on the current stream (no synchronisation),
    with the same outputs bit for bit."""
    if reads.device.type == "cuda":
        return _sketch_kernel(reads, read_lens, k, w, sketch_max,
                              alphabet_size)
    return sketch_ref(reads, read_lens, k, w, sketch_max, alphabet_size)


def _sketch_kernel(reads, read_lens, k, w, S, alphabet_size):
    from .l2_sweep import launch

    if reads.dim() != 2 or reads.dtype != torch.uint8:
        raise TypeError("reads must be a uint8 [B, L] tensor")
    _check(reads, k, w)
    B, L = reads.shape
    dev = reads.device
    reads = reads.contiguous()
    lens = read_lens.to(device=dev, dtype=torch.int64).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"read_lens must be [{B}], got {tuple(lens.shape)}")
    kcap, rb, spills, gring = sketch_plan(L, k, w, S)
    ws = (torch.empty(B * 2 * (S + 1), dtype=torch.int64, device=dev)
          if spills else None)
    # B x kcap keys, then B x kcap strand bytes
    ring = (torch.empty(B * kcap * 9, dtype=torch.uint8, device=dev)
            if gring else None)
    q_hash = torch.empty((B, S), dtype=torch.int64, device=dev)
    q_strand = torch.empty((B, S), dtype=torch.int8, device=dev)
    size = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return q_hash, q_strand, size, ovf
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    launch("sketch", dev, ptr(reads), ptr(lens),
           *map(ctypes.c_int, (B, L, k, w, S, int(alphabet_size == 4), kcap,
                               rb)),
           ptr(ws), ptr(ring), ptr(q_hash), ptr(q_strand), ptr(size),
           ptr(ovf))
    sketch.launches += 1
    return q_hash, q_strand, size, ovf


sketch.launches = 0  # kernel launches since the last reset


def sketch_ref(reads: torch.Tensor, read_lens: torch.Tensor, k: int, w: int,
               sketch_max: int, alphabet_size: int = 4):
    """The plain version of :func:`sketch`: a chain of torch ops."""
    S = sketch_max
    B = reads.shape[0]
    emit, h, st, _ = winnow_dense(reads, read_lens.to(torch.int64) - k + 1,
                                  k, w, alphabet_size)
    key = torch.where(emit, h, U32_MAX)
    # stable: among equal hashes the first window keeps the lead, so the
    # unique entry carries the first occurrence's strand (as lax.sort does
    # with the window id as second key)
    ks, order = torch.sort(key, dim=1, stable=True)
    sts = torch.gather(st, 1, order)
    uniq = ks != U32_MAX
    uniq[:, 1:] &= ks[:, 1:] != ks[:, :-1]
    n_unique = uniq.sum(dim=1)
    slot = torch.cumsum(uniq, dim=1) - 1
    # unique entries land in their slot; everything else in a spill column
    dest = torch.where(uniq & (slot < S), slot, S)
    q_hash = torch.full((B, S + 1), U32_MAX, dtype=torch.int64,
                        device=reads.device)
    q_strand = torch.zeros((B, S + 1), dtype=torch.int8, device=reads.device)
    q_hash.scatter_(1, dest, ks)
    q_strand.scatter_(1, dest, sts)
    return (q_hash[:, :S].contiguous(), q_strand[:, :S].contiguous(),
            torch.clamp(n_unique, max=S), n_unique > S)
