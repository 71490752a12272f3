"""Index lookup of every sketch hash.

Counterpart: ``batch_lookup``, ``metamaps_tpu/ops/batch_map.py:978``. The
TPU's radix directory and packed row gathers become one
``torch.searchsorted`` into the unique-hash CSR; the outputs are the same.
"""
from __future__ import annotations

import torch

from .tables import I32_MAX, U32_MAX, DeviceTables


def lookup(tables: DeviceTables, q_hash: torch.Tensor):
    """``q_hash`` int64 ``[B, S]`` (padded U32_MAX).

    Returns ``(start, count, total, qkey, dropped)``: ``start`` ``[B, S]``
    is the first hash-order row of each found hash (0 when absent);
    ``count`` ``[B, S]`` its number of occurrences, zeroed for missing
    hashes, padded slots and hashes at or above the frequency threshold;
    ``total`` ``[B]`` the row sums of ``count``; ``qkey`` ``[B, S]`` = 2 *
    lower_bound(row) + present, the row-space key the L2 setup compares
    against (I32_MAX for padded slots, never thresholded); ``dropped``
    ``[B]`` the occurrences of each read's hashes that the threshold
    removed. All int64."""
    U = tables.uniq_hash.shape[0]
    lb = torch.searchsorted(tables.uniq_hash, q_hash)
    found = lb < U
    if U:
        found &= tables.uniq_hash[lb.clamp(max=U - 1)] == q_hash
    arow = tables.uniq_start[lb]
    count = tables.uniq_start[(lb + 1).clamp(max=U)] - arow
    valid_q = q_hash != U32_MAX
    start = torch.where(found, arow, 0)
    qkey = torch.where(valid_q, 2 * arow + found.to(torch.int64), I32_MAX)
    count = torch.where(valid_q & found, count, 0)
    over = count >= tables.freq_threshold
    dropped = torch.where(over, count, 0).sum(dim=1)
    count = torch.where(over, 0, count)
    return start, count, count.sum(dim=1), qkey, dropped
