"""Batched read sketch: the sorted unique minimizer hashes of each read.

Counterpart: ``batch_sketch``, ``metamaps_tpu/ops/batch_map.py:909``.
"""
from __future__ import annotations

import torch

from .winnow import winnow_dense

U32_MAX = 0xFFFFFFFF


def sketch(reads: torch.Tensor, read_lens: torch.Tensor, k: int, w: int,
           sketch_max: int, alphabet_size: int = 4):
    """``reads`` uint8 ``[B, L]`` (right-padded), ``read_lens`` ``[B]``.

    Returns ``q_hash`` int64 ``[B, S]`` (ascending unique hashes, padded
    U32_MAX), ``q_strand`` int8 ``[B, S]`` (strand of each hash's first
    occurrence, padded 0), ``sketch_size`` int64 ``[B]`` (clipped to S) and
    ``overflow`` bool ``[B]`` (more than S unique hashes).
    """
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
