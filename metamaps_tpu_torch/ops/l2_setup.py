"""L2 event construction: each candidate's row-sorted event stream.

Counterpart: ``_make_candidate_setup_pos``,
``metamaps_tpu/ops/batch_map.py:1615``, whose docstring derives the event
formulation. Per occurrence t of the candidate's window there are at most
two transitions of its hash's activity: X at a_t = wpos_t - L + 1 (+base,
unless an overlapping same-hash predecessor in the window already covers
it) and Y at the next window position (-base, unless an overlapping
same-hash successor in the window takes over); base is 2 for hashes in the
read's sketch and 1 otherwise. The query rank of an occurrence is the
number of sketch hashes below its hash, found by a searchsorted of its
row-space key 2*hrow+1 into the read's ascending ``qkey`` row.

The same-hash links are exact positions (``DeviceTables.prev_same`` /
``next_same``), so the gates the JAX version evaluates on clamped 16-bit
deltas are plain comparisons here. The TPU merges the two ascending
families with a bitonic network; here one ``torch.sort`` orders the
concatenation. Order among events with equal rows does not change the
sweep's result: the lazy close scores only non-empty segments.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .l1 import occurrence_window
from .tables import I32_MAX, DeviceTables


@dataclass
class L2Setup:
    """Event streams [N, 2R] (rows ascending, padding rows I32_MAX last),
    the sweep's ``meta`` [N, 4] (s, row_lo, row_hi, n_ev), and the window
    state the finish stage reads back. Event arrays and ``meta`` are int32,
    the rest int64."""

    meta: torch.Tensor
    qrank: torch.Tensor
    signinq: torch.Tensor
    rows: torch.Tensor
    valid: torch.Tensor  # [N] bool, a real candidate (c_seq >= 0)
    overflow: torch.Tensor  # [N] bool, window wider than R
    beg0: torch.Tensor  # [N]
    L: torch.Tensor  # [N]
    occ_w: torch.Tensor  # [N, R] window wpos, I32_MAX past n_occ
    occ_hrow: torch.Tensor  # [N, R]
    occ_strand: torch.Tensor  # [N, R]
    occ_next: torch.Tensor  # [N, R] next same-hash position, or -1


def l2_setup(tables: DeviceTables, q_key, sketch_size, read_lens, c_seq,
             c_start, c_end, k: int, w: int, range_max: int,
             sketch_cols: int) -> L2Setup:
    """Per candidate ``n``: ``q_key`` [N, S] is its read's lookup key row,
    ``sketch_size``/``read_lens``/``c_*`` [N]. ``range_max`` (R) is the
    occurrence-window capacity (wider windows are flagged ``overflow`` and
    clipped); query ranks are clipped to ``sketch_cols`` (>= every s)."""
    dev = q_key.device
    R = range_max
    M = tables.n_minimizers
    valid = c_seq >= 0
    seq = c_seq.clamp(min=0)
    rlen = read_lens.to(torch.int64)
    L = rlen - (w - 1) - (k - 1)
    beg0, last_end = occurrence_window(tables, seq, c_start, c_end + rlen)
    n_occ = last_end - beg0
    overflow = n_occ > R
    t = torch.arange(R, device=dev)
    occ_v = t[None, :] < n_occ.clamp(max=R)[:, None]
    gi = (beg0[:, None] + t[None, :]).clamp(max=max(M - 1, 0))
    if M == 0:
        occ_v = torch.zeros_like(occ_v)
        gi = torch.zeros_like(gi)
        wpos = hrow = strand = nxt_tab = prv_tab = torch.zeros(
            1, dtype=torch.int64, device=dev)
    else:
        wpos, hrow, strand = tables.wpos, tables.hrow, tables.strand
        prv_tab, nxt_tab = tables.prev_same, tables.next_same

    def at(tab, i):  # entries of a table, widened after the gather
        return tab[i].to(torch.int64)

    # [N, R] temporaries are freed (del) as soon as they are dead: at a
    # chunk of ~900 candidates they set the mapping path's peak memory
    occ_w_raw = at(wpos, gi)
    occ_w = torch.where(occ_v, occ_w_raw, I32_MAX)
    occ_hrow = at(hrow, gi)
    occ_strand = at(strand, gi)
    prv = at(prv_tab, gi)
    nxt = at(nxt_tab, gi)
    del gi

    empty = ~occ_v[:, 0]
    p0 = torch.where(empty, 0, occ_w[:, 0])
    w_last = at(wpos, (last_end - 1).clamp(min=0, max=max(M - 1, 0)))
    p_max = torch.where(empty, -1, w_last - L)

    next_w = torch.cat(
        [occ_w[:, 1:], torch.full((occ_w.shape[0], 1), I32_MAX,
                                  dtype=torch.int64, device=dev)], dim=1)
    a_t = occ_w_raw - L[:, None] + 1
    del occ_w_raw

    # query rank and membership: qkey rows ascend (padding I32_MAX last)
    v_occ = 2 * occ_hrow + 1
    qk = q_key.to(torch.int64).contiguous()
    qrank = torch.searchsorted(qk, v_occ)
    S = qk.shape[1]
    in_q = (qrank < S) & (torch.gather(qk, 1, qrank.clamp(max=S - 1)) == v_occ)
    del v_occ
    base = torch.where(in_q, 2, 1)
    del in_q

    # X: an overlapping same-hash predecessor p inside the window
    # (p >= beg0, a_t <= b_p = wpos[p+1] - 1) cancels the start
    pc = prv.clamp(min=0)
    chain_prev = (
        (prv >= beg0[:, None])
        & (a_t <= at(wpos, (pc + 1).clamp(max=max(M - 1, 0))) - 1)
    )
    del pc, prv
    # Y: an overlapping same-hash successor r inside the window
    # (r < last_end, a_r <= b_t = next_w - 1) takes over the end
    nc = nxt.clamp(min=0)
    chain_next = (
        (nxt >= 0) & (nxt < last_end[:, None])
        & (at(wpos, nc) - L[:, None] + 1 <= next_w - 1)
    )
    del nc
    i32 = torch.int32
    # every key, sign and rank fits int32: the [N, 2R] arrays are built in
    # it (a stable sort of the same values gives the same order)
    x_key = torch.where(occ_v, a_t, I32_MAX).to(i32)
    del a_t
    x_sign = torch.where(occ_v & ~chain_prev, base, 0).to(i32)
    y_sign = torch.where(occ_v & ~chain_next, -base, 0).to(i32)
    del base, chain_prev, chain_next

    keys = torch.cat([x_key, next_w.to(i32)], dim=1)
    del x_key, next_w
    rows, order = torch.sort(keys, dim=1, stable=True)
    del keys
    signinq = torch.gather(torch.cat([x_sign, y_sign], dim=1), 1, order)
    del x_sign, y_sign
    qrank = qrank.clamp(max=sketch_cols).to(i32)
    qr = torch.gather(torch.cat([qrank, qrank], dim=1), 1, order)
    del qrank, order
    n_ev = (rows != I32_MAX).sum(dim=1)
    meta = torch.stack([sketch_size.to(torch.int64), p0, p_max, n_ev], dim=1)
    return L2Setup(
        meta=meta.to(i32).contiguous(),
        qrank=qr.contiguous(),
        signinq=signinq.contiguous(),
        rows=rows.contiguous(),
        valid=valid, overflow=overflow, beg0=beg0, L=L, occ_w=occ_w,
        occ_hrow=occ_hrow, occ_strand=occ_strand, occ_next=nxt,
    )
