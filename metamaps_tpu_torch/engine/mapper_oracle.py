"""Serial mapping oracle: exact mirror of the reference L1/L2 algorithm.

Counterpart: ``metamaps_tpu/engine/mapper_oracle.py``, of which this is a
jax-free copy; only ``_shared_sketch_count`` differs, in how it counts (by
union ranks instead of sorting the union, which is cheaper for wide
sketches: the L2 scan counts one window at every step), not in what it
counts. The port's engine falls back to it for reads that overflow a
capacity, and ``chip_smoke.py`` holds the engine against it on the card.

This is the behavioral specification for the batched device kernels in
``metamaps_tpu.ops`` — slow but faithful to src/map/include/computeMap.hpp:

- doL1Mapping (:277): read sketch (unique minimizer hashes), index lookups
  under the frequency threshold, hit sort, run-of-minimumHits candidate
  regions with overlap merging (:346-386);
- doL2Mapping / computeL2MappedRegions (:396-538): slide a super-window of
  ``countMinimizerWindows`` over the candidate's minimizer-index range,
  stopping at every position where either boundary iterator advances; the
  shared sketch count is |bottom-s(Q ∪ R_win) ∩ Q ∩ R_win|; the optimum
  keeps the first maximal state's [beg, end) range and the mean of the first
  and last maximal states' begin wpos;
- acceptance via the 90%-CI identity upper bound, strand by minimizer votes
  over the optimal range (slidingMap.hpp:232-254), and the top-1%-of-best
  report filter (:546-588).

Also used as the CPU fallback engine for small inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from metamaps_tpu_torch import stats

from ..ops.winnow import winnow_np


@dataclass
class ReadMapping:
    query_len: int
    ref_start: int
    ref_end: int
    ref_seqid: int
    nuc_identity: float  # float32 semantics, percent
    nuc_identity_ub: float
    sketch_size: int
    conserved: int
    strand: int  # +1 / -1


def sketch_read(seq: np.ndarray, k: int, w: int, alphabet_size: int = 4):
    """Read minimizers + unique-hash sketch (doL1Mapping steps 1-2).

    Returns (sketch_hashes sorted unique, sketch_strand aligned,
    n_minimizers). The reference's std::sort is unstable; we keep the first
    position's strand for duplicate hashes (deterministic)."""
    h, p, s = winnow_np(seq, k, w, alphabet_size)
    if h.size == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int8), 0
    order = np.argsort(h, kind="stable")
    hs, ss = h[order], s[order]
    first = np.ones(hs.size, dtype=bool)
    first[1:] = hs[1:] != hs[:-1]
    return hs[first], ss[first], h.size


def l1_candidates(shard, q_hashes: np.ndarray, read_len: int, minimum_hits: int):
    """computeL1CandidateRegions parity. Returns list of
    (seqid, range_start, range_end)."""
    start, count = shard.lookup_counts(q_hashes)
    keep = count < shard.freq_threshold
    idx_parts = [
        np.arange(s, s + c, dtype=np.int64)
        for s, c in zip(start[keep], count[keep])
    ]
    if not idx_parts:
        return []
    idx = np.concatenate(idx_parts)
    hit_seqid = shard.seqid_byhash[idx]
    hit_wpos = shard.wpos_byhash[idx]
    hit_strand = shard.strand_byhash[idx].astype(np.int32)
    # sort by (seqId, wpos, strand) — MinimizerMetaData::operator<
    order = np.lexsort((hit_strand, hit_wpos, hit_seqid))
    hit_seqid, hit_wpos = hit_seqid[order], hit_wpos[order]

    m = max(1, minimum_hits)
    n = hit_seqid.size
    cands = []
    for i in range(n - m + 1):
        j = i + m - 1
        if hit_seqid[j] == hit_seqid[i] and hit_wpos[j] - hit_wpos[i] < read_len:
            c_seq = int(hit_seqid[i])
            c_start = max(0, int(hit_wpos[j]) - read_len + 1)
            c_end = int(hit_wpos[i])
            if cands and cands[-1][0] == c_seq and cands[-1][2] >= c_start:
                cands[-1][2] = max(c_end, cands[-1][2])
            else:
                cands.append([c_seq, c_start, c_end])
    return [tuple(c) for c in cands]


def _shared_sketch_count(q_sorted, q_index, r_hashes_window, s):
    """|bottom-s(Q ∪ R) ∩ Q ∩ R| for one window (slidingMap semantics).

    Q (sorted, unique, non-empty) and R's hashes outside Q are disjoint, so
    a hash c common to both has union rank #(Q < c) + #(R-only < c), and
    the count is the number of common hashes of rank below s (the union
    rank of ``_strand_votes``), with no sort of the union."""
    r_unique = np.unique(r_hashes_window)
    pos = np.searchsorted(q_sorted, r_unique)
    in_q = q_sorted[np.minimum(pos, q_sorted.size - 1)] == r_unique
    rank = pos[in_q] + np.searchsorted(r_unique[~in_q], r_unique[in_q])
    return int(np.count_nonzero(rank < s))


def l2_map_region(shard, q_sorted, s, read_len, k, w, candidate):
    """computeL2MappedRegions parity. Returns
    (shared, mean_opt_pos, opt_beg, opt_end) or None when no window scored."""
    c_seq, c_start, c_end = candidate
    first_start = shard.search_index(c_seq, c_start)
    n_index = shard.wpos.size
    if first_start >= n_index:
        return None
    L = read_len - (w - 1) - (k - 1)
    first_end = shard.search_index(c_seq, int(shard.wpos[first_start]) + L)
    last_end = shard.search_index(c_seq, c_end + read_len)

    beg, end = first_start, first_end
    sw_pos = int(shard.wpos[beg])

    best_shared = 0
    best_beg = best_end = None
    begin_opt = last_opt = None

    while (last_end - end) > 0:
        r_window = shard.hash_pos_order[beg:end]
        shared = _shared_sketch_count(q_sorted, None, r_window, s) if end > beg else 0
        if shared > best_shared:
            best_shared = shared
            best_beg, best_end = beg, end
            begin_opt = int(shard.wpos[beg])
            last_opt = int(shard.wpos[beg])
        elif shared == best_shared and best_shared > 0:
            last_opt = int(shard.wpos[beg])

        if beg + 1 >= n_index or end >= n_index:
            break
        adv_beg = int(shard.wpos[beg + 1]) - sw_pos
        adv_end = int(shard.wpos[end]) - (sw_pos + L - 1)
        advance = min(adv_beg, adv_end)
        if advance <= 0:
            # crossing a contig boundary in the index — the reference asserts
            # here in debug builds; stop scanning this candidate
            break
        sw_pos += advance
        if advance == adv_beg:
            beg += 1
        if advance == adv_end:
            end += 1

    if best_shared == 0 or begin_opt is None:
        return None
    return best_shared, (begin_opt + last_opt) // 2, best_beg, best_end


def _strand_votes(shard, q_sorted, q_strand, s, beg, end):
    """computeStatistics parity (slidingMap.hpp:232-254) over the optimal
    range, vectorized: votes from the first s union keys present in both;
    the ref strand for duplicate hashes is the last occurrence in position
    order (the map's wposR revision)."""
    r_hash = shard.hash_pos_order[beg:end]
    r_strand = shard.strand[beg:end].astype(np.int32)
    order = np.argsort(r_hash, kind="stable")
    rh = r_hash[order]
    rs = r_strand[order]
    if rh.size:
        last = np.ones(rh.size, dtype=bool)
        last[:-1] = rh[1:] != rh[:-1]
        rh_u, rs_u = rh[last], rs[last]
    else:
        rh_u, rs_u = rh, rs
    unique_ref = int(rh_u.size)
    if rh_u.size == 0:
        return 0, 0

    # union rank of q_j = j + #(ref-only hashes < q_j)
    pos = np.searchsorted(rh_u, q_sorted)
    in_r = (pos < rh_u.size) & (rh_u[np.minimum(pos, max(rh_u.size - 1, 0))] == q_sorted)
    ref_only = rh_u[~np.isin(rh_u, q_sorted)]
    rank = np.arange(q_sorted.size) + np.searchsorted(ref_only, q_sorted)
    votes_mask = in_r & (rank < s)
    votes = int(
        np.sum(
            q_strand[votes_mask].astype(np.int32)
            * rs_u[pos[votes_mask]].astype(np.int32)
        )
    )
    return votes, unique_ref


def map_read(shard, params, seq: np.ndarray) -> List[ReadMapping]:
    """mapSingleQuerySeq parity: L1 + L2 for one read against one shard."""
    k, w, a = params.kmer_size, params.window_size, params.alphabet_size
    read_len = int(len(seq))
    q_sorted, q_strand, _ = sketch_read(seq, k, w, a)
    s = int(q_sorted.size)
    if s == 0:
        return []
    minimum_hits = stats.estimate_minimum_hits_relaxed(s, k, params.percentage_identity)
    cands = l1_candidates(shard, q_sorted, read_len, minimum_hits)

    results: List[ReadMapping] = []
    for cand in cands:
        l2 = l2_map_region(shard, q_sorted, s, read_len, k, w, cand)
        if l2 is None:
            shared, mean_pos = 0, 0
            beg = end = None
        else:
            shared, mean_pos, beg, end = l2
        mash = stats.j2md(np.float32(1.0) * shared / s, k)
        mash_lb = stats.md_lower_bound(mash, s, k, 0.9)
        nuc_identity = float(np.float32(100 * (1 - np.float32(mash))))
        nuc_identity_ub = float(np.float32(100 * (1 - np.float32(mash_lb))))
        if nuc_identity_ub >= params.percentage_identity:
            if beg is None:
                strand = -1
            else:
                votes, _ = _strand_votes(shard, q_sorted, q_strand, s, beg, end)
                strand = 1 if votes > 0 else -1
            results.append(
                ReadMapping(
                    query_len=read_len,
                    ref_start=mean_pos,
                    ref_end=mean_pos + read_len - 1,
                    ref_seqid=cand[0],
                    nuc_identity=nuc_identity,
                    nuc_identity_ub=nuc_identity_ub,
                    sketch_size=s,
                    conserved=shared,
                    strand=strand,
                )
            )
    return results


def report_filter(mappings: List[ReadMapping], report_all: bool) -> List[ReadMapping]:
    """Top-1%-of-best filter (reportReadMappings, computeMap.hpp:546-563)."""
    if report_all or not mappings:
        return mappings
    best = max(m.nuc_identity for m in mappings)
    return [m for m in mappings if m.nuc_identity >= best - 1.0]
