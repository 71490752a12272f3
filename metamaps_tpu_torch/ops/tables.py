"""The port's device-resident index tables.

Counterpart: ``DeviceShard`` and its numpy table builders in
``metamaps_tpu/ops/batch_map.py:547-900``. The TPU layout (packed 8-, 9- and
16-wide lookup rows, remixed bucket keys, 16-bit clamped chain deltas) exists
because TPU gathers are scalarized; on the GPU the simplest layout that gives
the same outputs is kept instead:

- hash order: the unique-hash CSR (``uniq_hash`` / ``uniq_start``) that
  ``torch.searchsorted`` probes, and each row's packed (seqid, wpos) as one
  int64 ``gpos_byhash`` (sorting it sorts hits by (seqid, wpos));
- position order: ``pos_key`` = seqid << 32 | wpos (ascending, so the L1/L2
  window bounds within a contig are one searchsorted), ``wpos``, ``hrow``
  (each entry's first row in hash order), ``strand``;
- same-hash predecessor/successor links within a contig as int32 positions
  (``prev_same`` / ``next_same``, -1 when absent). Exact positions replace
  the clamped deltas of ``build_chain_deltas``, so the JAX engine's read
  bucket cap does not apply.

Hashes are uint32 values held in int64 tensors, so sort order is uint32
order. :func:`device_tables` builds everything with torch ops on ``device``
from a ``SketchShard``'s numpy arrays, built by either package's index
module.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

I32_MAX = 2**31 - 1
U32_MAX = 0xFFFFFFFF


@dataclass
class DeviceTables:
    uniq_hash: torch.Tensor  # [U] int64, ascending unique hashes
    uniq_start: torch.Tensor  # [U+1] int64, first hash-order row of each
    gpos_byhash: torch.Tensor  # [M] int64, seqid << 32 | wpos in hash order
    pos_key: torch.Tensor  # [M] int64, seqid << 32 | wpos (position order)
    wpos: torch.Tensor  # [M] int32, position order
    hrow: torch.Tensor  # [M] int32, first hash-order row of the entry's hash
    strand: torch.Tensor  # [M] int8 (+1 / -1), position order
    prev_same: torch.Tensor  # [M] int32, previous same-hash entry or -1
    next_same: torch.Tensor  # [M] int32, next same-hash entry or -1
    freq_threshold: int

    @property
    def device(self) -> torch.device:
        return self.pos_key.device

    @property
    def n_minimizers(self) -> int:
        return int(self.pos_key.shape[0])

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in vars(self).values()
            if isinstance(t, torch.Tensor)
        )


def _same_hash_links(key: torch.Tensor):
    """(prev, next) int32 position links between entries with an equal
    ``key`` (seqid << 32 | hash), in position order."""
    M = key.shape[0]
    # stable: equal keys keep position order, so neighbours in the sorted
    # order are consecutive occurrences
    ks, order = torch.sort(key, stable=True)
    same = ks[1:] == ks[:-1]
    del ks
    a, b = order[:-1][same], order[1:][same]
    del order, same
    # allocated after the sort, whose buffers are the build's peak
    prev = torch.full((M,), -1, dtype=torch.int32, device=key.device)
    nxt = torch.full_like(prev, -1)
    prev[b] = a.to(torch.int32)
    nxt[a] = b.to(torch.int32)
    return prev, nxt


def device_tables(shard, device) -> DeviceTables:
    """Upload a ``SketchShard`` and derive the port's lookup tables on
    ``device`` (see the module docstring). One table is built at a time and
    each input is freed once used: an int64 column of a 1 Gbp shard is
    0.94 GB, and holding every input at once took the build's peak to 2.5
    times the tables' size."""
    dev = torch.device(device)
    shard.ensure_hash_order_views()

    def t64(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(dev)

    hs = t64(shard.hash_sorted)
    M = hs.shape[0]
    new_run = torch.ones(M, dtype=torch.bool, device=dev)
    if M > 1:
        new_run[1:] = hs[1:] != hs[:-1]
    first = torch.nonzero(new_run).flatten()
    del new_run
    uniq_hash = hs[first]
    uniq_start = torch.cat(
        [first, torch.tensor([M], dtype=torch.int64, device=dev)])
    del first
    hash_pos = t64(shard.hash_pos_order)
    hrow = torch.searchsorted(hs, hash_pos).to(torch.int32)
    del hs

    seqid = t64(shard.seqid) << 32
    wpos = t64(shard.wpos)
    pos_key = seqid | wpos
    wpos = wpos.to(torch.int32)
    key = seqid.bitwise_or_(hash_pos)
    del seqid, hash_pos
    prev_same, next_same = _same_hash_links(key)
    del key
    gpos_byhash = t64(shard.seqid_byhash).bitwise_left_shift_(32)
    gpos_byhash.bitwise_or_(t64(shard.wpos_byhash))
    return DeviceTables(
        uniq_hash=uniq_hash,
        uniq_start=uniq_start,
        gpos_byhash=gpos_byhash,
        pos_key=pos_key,
        wpos=wpos,
        hrow=hrow,
        strand=t64(shard.strand).to(torch.int8),
        prev_same=prev_same,
        next_same=next_same,
        freq_threshold=int(shard.freq_threshold),
    )
