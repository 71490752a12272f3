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

The JAX engine's capacities are kept as overflow flags: a read with more
than ``hits_max`` hits or more than ``cands_max`` regions goes to the
serial oracle, as there. The JAX detector's limit of 32 static shifts
(``metamaps_tpu/ops/batch_map.py:51``), which sends a read whose minimum
hits pass it to the oracle, is not kept: here the shift is an index offset
of any size, and such a read (a ~60 kb read at w = 3 and ``--pi 75`` has
~250) gets the oracle's lines from its own L1 and L2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from metamaps_tpu_torch import stats

from .tables import DeviceTables

_LOW32 = 0xFFFFFFFF
_MINHITS: dict = {}  # (k, pi) -> read-only table, grown on demand
_MINHITS_BLOCK = 2048  # sketch sizes evaluated at a time


def _j2md_vec(j: np.ndarray, k: int) -> np.ndarray:
    """:func:`stats.j2md` on a float32 array, the same bits per element (the
    logarithm is ``math.log``'s, as in the scalar)."""
    j64 = j.astype(np.float64)
    live = (j != 0) & (j != 1)
    arg = 2.0 * j64[live] / (1.0 + j64[live])
    md = np.empty(j.shape, np.float32)
    md[live] = ((-1.0 / k) * np.array([math.log(a) for a in arg.tolist()],
                                      np.float64)).astype(np.float32)
    md[j == 0] = 1.0
    md[j == 1] = 0.0
    return md


def _md2j_vec(d: np.ndarray, k: int) -> np.ndarray:
    """:func:`stats.md2j` on a float32 array, the same bits per element."""
    kd = np.float32(k) * d.astype(np.float32)
    e = np.array([math.exp(v) for v in kd.astype(np.float64).tolist()],
                 np.float64)
    return (1.0 / (2.0 * e - 1.0)).astype(np.float32)


def _passes(i: np.ndarray, s: np.ndarray, k: int, pi: float) -> np.ndarray:
    """The test of ``stats.estimate_minimum_hits_relaxed``'s loop for each
    pair (i hits, sketch size s): the upper bound of the identity that i
    shared hashes of s give is at least pi. Every step narrows to float32
    where the scalar does."""
    d = _j2md_vec((i.astype(np.float64) / s).astype(np.float32), k)
    q2 = (1.0 - float(np.float32(0.9))) / 2.0  # md_lower_bound's, ci 0.9
    x = stats.binom_quantile_complement_vec(
        s, _md2j_vec(d, k).astype(np.float64), q2)
    d_lower = _j2md_vec(x.astype(np.float32) / s.astype(np.float32), k)
    return 100.0 * (1.0 - d_lower.astype(np.float64)) >= pi


def _relaxed_minhits(s: np.ndarray, k: int, pi: float) -> np.ndarray:
    """``stats.estimate_minimum_hits_relaxed(s, k, pi)`` for every s >= 1 of
    ``s``, vectorised. The scalar walks i down from start(s) =
    ``estimate_minimum_hits`` while i passes :func:`_passes`: it returns
    start(s) if start(s) fails, else one above the highest failing i (0 if
    none fails). Here each s tests a window of i below start(s) at once,
    and a window with no failure that does not reach 0 is widened and
    tested again, so the answer is the scalar's whatever the windows."""
    s = s.astype(np.int64)
    jac = stats.md2j(float(np.float32(1.0 - float(pi) / 100.0)), k)
    start = np.ceil(1.0 * s.astype(np.float64) * jac).astype(np.int64)
    out = np.empty_like(s)
    todo = np.arange(s.size)
    span = start // 4 + 4
    while todo.size:
        st, sz = start[todo], s[todo]
        lo = np.maximum(st - span[todo], 0)
        n = st - lo + 1
        row = np.repeat(np.arange(todo.size), n)
        i = st[row] - (np.arange(row.size) - (np.cumsum(n) - n)[row])
        fail = ~_passes(i, sz[row], k, pi)
        # the highest failing i of each row (rows run from start(s) down)
        hi_fail = np.full(todo.size, -1, np.int64)
        np.maximum.at(hi_fail, row[fail], i[fail])
        done = (hi_fail >= 0) | (lo == 0)
        res = np.where(hi_fail == st, st, hi_fail + 1)
        out[todo[done]] = res[done]
        span[todo] *= 4
        todo = todo[~done]
    return out


def minhits_table(s_max: int, k: int, pi: float) -> np.ndarray:
    """minimumHits per sketch size 0..s_max (``mapper_jax._minhits_table``,
    ``metamaps_tpu/engine/mapper_jax.py:52``), the values of
    ``stats.estimate_minimum_hits_relaxed`` (:func:`_relaxed_minhits`
    computes them vectorised). A value depends on s alone, so each is
    computed once per process for each (k, pi) and kept, like the JAX
    package's ``lru_cache``, in one table that grows when a larger s_max is
    asked for; every engine, one per shard and query file, reuses it.
    Returns a read-only view."""
    key = (int(k), float(pi))
    t = _MINHITS.get(key, np.zeros(1, np.int32))
    if t.size <= s_max:
        grown = np.zeros(s_max + 1, np.int32)
        grown[:t.size] = t
        for a in range(t.size, s_max + 1, _MINHITS_BLOCK):
            b = min(a + _MINHITS_BLOCK, s_max + 1)
            grown[a:b] = _relaxed_minhits(np.arange(a, b), k, pi)
        grown.setflags(write=False)
        _MINHITS[key] = t = grown
    return t[:s_max + 1]


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
    d = torch.clamp(minhits[sketch_size], min=1) - 1
    overflow = h_ovf

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
    overflow = overflow | (n_regions > cands_max)
    beg0, last_end = occurrence_window(tables, r_seq, r_start,
                                       r_end + read_lens[r_read])
    return L1Regions(r_read, r_seq, r_start, r_end, beg0, last_end,
                     n_regions, overflow)
