"""L2 scoring of a candidate slab: setup, sweep, optimum and strand votes.

Counterpart: ``_l2_pallas_batch`` (``metamaps_tpu/ops/batch_map.py:1874``)
with its ``finish`` (``:1910``), stacked as ``batch_l2_gather`` (``:2421``)
stacks them. Per candidate: the best shared count, the mean of the first and
last maximal positions, the first maximal state's map range [ob, oe), the
window-overflow flag and the strand votes over that range
(computeStatistics, slidingMap.hpp:232-254).
"""
from __future__ import annotations

import torch

from .l2_setup import L2Setup, l2_setup
from .l2_sweep import l2_event_sweep
from .tables import I32_MAX, DeviceTables


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def l2_finish(st: L2Setup, sweep_out, q_key, q_strand, sketch_size,
              sketch_cols: int) -> torch.Tensor:
    """Optimum extraction and strand votes from the sweep's (best, first,
    last). Returns [6, N] int32: shared, mean_pos, opt_beg, opt_end,
    overflow, strand_votes."""
    dev = q_key.device
    b, fp, lp, _ = sweep_out.to(torch.int64).T.contiguous()
    occ_w = st.occ_w
    R = occ_w.shape[1]
    has_best = (b > 0) & st.valid

    def rec_pos(p):
        # largest window position <= p, clamped to the first
        i = torch.searchsorted(occ_w, p[:, None], right=True) - 1
        return torch.gather(occ_w, 1, i.clamp(min=0))[:, 0]

    mean_pos = torch.where(has_best, (rec_pos(fp) + rec_pos(lp)) // 2, 0)
    n_le = torch.searchsorted(occ_w, fp[:, None], right=True)[:, 0]
    n_lt = torch.searchsorted(occ_w, (fp + st.L)[:, None])[:, 0]
    ob = torch.where(has_best, st.beg0 + (n_le - 1).clamp(min=0), 0)
    oe = torch.where(has_best, st.beg0 + n_lt, 0)

    # strand votes over [ob, oe): per distinct window hash the voting
    # strand is its last occurrence in the range (no same-hash successor
    # before oe); the union rank of query slot j is j + #(range hashes
    # below it) - #(common hashes below it)
    r_abs = st.beg0[:, None] + torch.arange(R, device=dev)[None, :]
    active = (r_abs >= ob[:, None]) & (r_abs < oe[:, None]) & has_best[:, None]
    is_last = active & ((st.occ_next < 0) | (st.occ_next >= oe[:, None]))
    v = torch.where(is_last, 2 * st.occ_hrow + 1, I32_MAX)
    v_sorted, order = torch.sort(v, dim=1)
    strand_sorted = torch.gather(st.occ_strand, 1, order)
    qk = q_key[:, :sketch_cols].to(torch.int64).contiguous()
    pos = torch.searchsorted(v_sorted, qk)
    posc = pos.clamp(max=R - 1)
    present = ((pos < R) & (qk != I32_MAX)
               & (torch.gather(v_sorted, 1, posc) == qk))
    pres = present.to(torch.int64)
    commons_before = torch.cumsum(pres, dim=1) - pres
    j = torch.arange(qk.shape[1], device=dev)[None, :]
    rank = j + pos - commons_before
    take = present & (rank < sketch_size.to(torch.int64)[:, None])
    votes = torch.where(
        take,
        q_strand[:, :sketch_cols].to(torch.int64)
        * torch.gather(strand_sorted, 1, posc),
        0,
    ).sum(dim=1)
    res = torch.stack([
        torch.where(has_best, b, 0), mean_pos, ob, oe,
        (st.overflow & st.valid).to(torch.int64), votes,
    ])
    return res.to(torch.int32)


def l2_gather(tables: DeviceTables, q_key, q_strand, sketch_size, read_lens,
              rows, c_seq, c_start, c_end, *, k: int, w: int, range_max: int,
              sketch_cols: int) -> torch.Tensor:
    """L2 scoring of a slab of candidates. ``q_key``/``q_strand`` [B, S] and
    ``sketch_size``/``read_lens`` [B] are per read; ``rows`` [K] picks each
    candidate's read, ``c_seq``/``c_start``/``c_end`` [K] its region
    (``c_seq`` -1 for padding). ``range_max`` is the window capacity R and
    ``sketch_cols`` (>= every member's sketch size) sets the rank-plane
    width round_up(sketch_cols + 1, 128). Returns [6, K] int32 as
    :func:`l2_finish`."""
    rows_c = rows.clamp(min=0)
    qk = q_key[rows_c]
    qs = q_strand[rows_c]
    ss = sketch_size[rows_c]
    st = l2_setup(tables, qk, ss, read_lens[rows_c], c_seq, c_start, c_end,
                  k, w, range_max, sketch_cols)
    sweep = l2_event_sweep(st.meta, st.qrank, st.signinq, st.rows,
                           round_up(sketch_cols + 1, 128))
    return l2_finish(st, sweep, qk, qs, ss, sketch_cols)
