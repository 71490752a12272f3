"""L1 candidate regions: hit expansion, run-of-minimum-hits detection,
overlap merge, and each region's occurrence window in the index.

Counterpart: ``batch_l1_expand``, ``metamaps_tpu/ops/batch_map.py:1230``,
plus the occurrence counts of ``_stage1b_body`` (``:2053``); semantics are
computeL1CandidateRegions (computeMap.hpp:346-386) as in the serial oracle.

The TPU version expands hits into a fixed [B, H] grid with a merge-sort
trick and selects the (m-1)-shifted neighbour through one-hot sums over 32
static shifts. Here the hits of the whole batch are one flat CSR expansion
(``repeat_interleave``), sorted once by (read, seqid, wpos); the shifted
neighbour is a plain index offset and regions come out as a flat list.

The JAX engine's capacities are kept as overflow flags, so exactly the
reads it sends to the serial oracle are flagged here too: more than
``hits_max`` hits, more than ``cands_max`` regions, or a minimum-hits value
beyond its shift limit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from metamaps_tpu_torch import stats

from .tables import DeviceTables

MINHITS_SHIFT_MAX = 32  # the JAX detector's static shift limit
_LOW32 = 0xFFFFFFFF


def minhits_table(s_max: int, k: int, pi: float) -> np.ndarray:
    """minimumHits per sketch size 0..s_max (``mapper_jax._minhits_table``,
    ``metamaps_tpu/engine/mapper_jax.py:52``)."""
    t = np.zeros(s_max + 1, np.int32)
    for s in range(1, s_max + 1):
        t[s] = stats.estimate_minimum_hits_relaxed(s, k, pi)
    return t


@dataclass
class L1Regions:
    """Candidate regions of a read batch, flat and in (read, region) order.

    ``read``/``seq``/``start``/``end`` [R] int64; ``beg0``/``last_end`` [R]
    the region's occurrence window [beg0, last_end) in position order
    (n_occ = last_end - beg0); ``n_regions`` [B] and ``overflow`` [B] per
    read."""

    read: torch.Tensor
    seq: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    beg0: torch.Tensor
    last_end: torch.Tensor
    n_regions: torch.Tensor
    overflow: torch.Tensor

    @property
    def n_occ(self) -> torch.Tensor:
        return self.last_end - self.beg0


def occurrence_window(tables: DeviceTables, seq, start, end_excl):
    """Lower bounds of wpos ``start`` and ``end_excl`` within contig ``seq``
    (the reference's searchIndex, winSketch.hpp:506-517): the occurrence
    window [beg0, last_end) in position order."""
    key = seq << 32
    beg0 = torch.searchsorted(tables.pos_key, key | start.clamp(min=0))
    last_end = torch.searchsorted(tables.pos_key, key | end_excl.clamp(min=0))
    return beg0, last_end


def l1_regions(tables: DeviceTables, start, count, total, sketch_size,
               read_lens, minhits: torch.Tensor, hits_max: int,
               cands_max: int) -> L1Regions:
    """``start``/``count`` [B, S] and ``total`` [B] from :func:`lookup`;
    ``minhits`` the :func:`minhits_table` as an int64 tensor."""
    dev = start.device
    B = start.shape[0]
    read_lens = read_lens.to(torch.int64)
    h_ovf = total > hits_max
    m = torch.clamp(minhits[sketch_size], min=1)
    d = m - 1
    overflow = h_ovf | (d >= MINHITS_SHIFT_MAX)

    # ---- CSR expansion of every (read, sketch slot) run -----------------
    cnt = torch.where(h_ovf[:, None], 0, count)
    nz = cnt > 0
    reps = cnt[nz]
    b_idx = torch.nonzero(nz)[:, 0]
    n_hits = int(reps.sum())
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n_hits == 0:
        return L1Regions(empty, empty, empty, empty, empty, empty,
                         torch.zeros(B, dtype=torch.int64, device=dev),
                         overflow)
    run_off = torch.cumsum(reps, 0) - reps
    idx = (torch.repeat_interleave(start[nz] - run_off, reps)
           + torch.arange(n_hits, device=dev))
    hit_read = torch.repeat_interleave(b_idx, reps)
    g = tables.gpos_byhash[idx]

    # ---- sort hits by (read, seqid, wpos): two stable passes -------------
    g, o = torch.sort(g, stable=True)
    hit_read, o2 = torch.sort(hit_read[o], stable=True)
    g = g[o2]
    h_seq = g >> 32
    h_pos = g & _LOW32
    seg_end = torch.searchsorted(
        hit_read, torch.arange(B, device=dev), right=True)

    # ---- run-of-minimumHits candidates: hit i with its (m-1)-th successor
    i = torch.arange(n_hits, device=dev)
    j = i + d[hit_read]
    jc = j.clamp(max=n_hits - 1)
    rl = read_lens[hit_read]
    cand = ((j < seg_end[hit_read]) & (h_seq[jc] == h_seq)
            & (h_pos[jc] - h_pos < rl))
    ci = torch.nonzero(cand).flatten()
    c_read = hit_read[ci]
    c_seq = h_seq[ci]
    c_start = torch.clamp(h_pos[jc[ci]] - rl[ci] + 1, min=0)
    c_end = h_pos[ci]

    # ---- overlap merge: within a (read, contig) run c_end is nondecreasing,
    # so the previous candidate carries the open region's end
    merged = torch.zeros_like(cand[ci])
    if ci.numel() > 1:
        merged[1:] = ((c_read[1:] == c_read[:-1]) & (c_seq[1:] == c_seq[:-1])
                      & (c_end[:-1] >= c_start[1:]))
    new = ~merged
    rid = torch.cumsum(new, 0) - 1
    n_reg = int(new.sum())
    r_read = c_read[new]
    r_seq = c_seq[new]
    r_start = torch.full((n_reg,), 2**62, dtype=torch.int64, device=dev)
    r_start.scatter_reduce_(0, rid, c_start, "amin")
    r_end = torch.full((n_reg,), -1, dtype=torch.int64, device=dev)
    r_end.scatter_reduce_(0, rid, c_end, "amax")

    n_regions = torch.bincount(r_read, minlength=B)
    overflow |= n_regions > cands_max
    beg0, last_end = occurrence_window(tables, r_seq, r_start,
                                       r_end + read_lens[r_read])
    return L1Regions(r_read, r_seq, r_start, r_end, beg0, last_end,
                     n_regions, overflow)
