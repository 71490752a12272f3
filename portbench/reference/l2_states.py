"""The reference's L2 super-window, every state of a region scored at once.

:func:`portbench.reference.mapping.l2_best` scores each state of the window
by set arithmetic on its hashes, one state after another: about 1,800
states a candidate region, ~0.2 s a region on a sandbox's CPU. Where a read
meets several strains of its species that cost grows with the regions, and
a run's check of 449 reads took 412 s on the card's host. This module gives
the same numbers from a table per region.

A hash ``c`` both the read (sketch ``q``, ``s`` hashes) and a window hold
counts as shared where it is among the ``s`` smallest of their union:
``#(q < c) + #(window-only hashes < c) < s``. Where a region's hashes are
distinct, the window-only hashes below ``c`` in positions ``[b, e)`` are
one difference of prefix counts, so the shared count of every state is a
sum over the region's common hashes. A region that holds a hash twice is
scored by :func:`mapping.l2_best` itself.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import mapping

#: the states of one region scored per block (bounds the tables' memory)
STATE_BLOCK = 1024
per_state = mapping.l2_best


def l2_best(index, q: np.ndarray, read_len: int, k: int, w: int, region):
    """:func:`mapping.l2_best`'s result for the same arguments: (shared,
    mean start of the first and last best windows, first best window's
    [begin, end) indices) or None."""
    contig, lo, hi = region
    h, pos, _ = index.contigs[contig]
    span = read_len - (w - 1) - (k - 1)
    start = int(np.searchsorted(pos, lo))
    stop = int(np.searchsorted(pos, hi + read_len))
    vals = h[start:stop]
    if np.unique(vals).size < vals.size:
        return per_state(index, q, read_len, k, w, region)
    x0 = int(pos[start])
    xs = np.union1d(pos[start:stop],
                    pos[np.searchsorted(pos, x0 + span):stop] - span + 1)
    begs = np.searchsorted(pos, xs, side="right") - 1
    ends = np.searchsorted(pos, xs + span)
    live = ends < stop
    begs, ends = begs[live], ends[live]
    if begs.size == 0:
        return None
    s = q.size
    common = np.flatnonzero(np.isin(vals, q, assume_unique=True))
    c_val = vals[common]
    slack = s - np.searchsorted(q, c_val)  # s - #(q < c)
    # below[i, j]: window-only hashes below common hash j among the
    # region's first i positions
    only = ~np.isin(vals, q, assume_unique=True)
    below = np.zeros((vals.size + 1, common.size), np.int32)
    np.cumsum(only[:, None] & (vals[:, None] < c_val[None, :]), axis=0,
              out=below[1:])
    b_rel, e_rel = begs - start, ends - start
    scores = np.empty(begs.size, np.int64)
    for a in range(0, begs.size, STATE_BLOCK):
        b, e = b_rel[a:a + STATE_BLOCK, None], e_rel[a:a + STATE_BLOCK, None]
        inside = (common[None, :] >= b) & (common[None, :] < e)
        counted = (below[e[:, 0]] - below[b[:, 0]]) < slack[None, :]
        scores[a:a + STATE_BLOCK] = np.sum(inside & counted, axis=1)
    best = int(scores.max())
    if best == 0:
        return None
    hit = np.flatnonzero(scores == best)
    i, j = hit[0], hit[-1]
    return best, (int(pos[begs[i]]) + int(pos[begs[j]])) // 2, int(begs[i]), int(ends[i])
