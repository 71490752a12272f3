"""Contig partitions of one host index, balanced by minimizer count.

Counterpart: ``metamaps_tpu/parallel/sharded_map.py``, of which only
:func:`partition_contigs` is ported. ``stack_shards`` pads every partition
to common shapes because ``shard_map`` needs one shape per argument; the
port's engines take each partition with its own shapes. ``sharded_map_step``
returns per-partition candidate grids [S, B, C]; the port's engine has no
candidate grid, and the grid's contract (each partition's candidates equal
a one-partition run) is held at the level of
``ShardedMapperEngine.map_reads`` (``parallel/sharded_engine.py``).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..engine.index import SketchShard


def partition_contigs(shard: SketchShard, n_parts: int) -> List[SketchShard]:
    """Split one host index into n contig-partitioned shards, balanced by
    minimizer count (greedy). Shard-local seqids restart at 0, mirroring the
    reference's per-shard numbering."""
    n_contigs = len(shard.contig_names)
    sizes = [
        int(shard.contig_offsets[i + 1] - shard.contig_offsets[i])
        for i in range(n_contigs)
    ]
    order = np.argsort(sizes)[::-1]
    assignment = [[] for _ in range(n_parts)]
    load = [0] * n_parts
    for ci in order:
        tgt = int(np.argmin(load))
        assignment[tgt].append(int(ci))
        load[tgt] += sizes[ci]
    return [sub_shard(shard, sorted(ids)) for ids in assignment]


def sub_shard(shard: SketchShard, contig_ids: List[int]) -> SketchShard:
    """The index of the contigs ``contig_ids`` (ascending) of ``shard``,
    renumbered from 0, with its own frequency threshold."""
    sub = SketchShard()
    sub_parts = []
    for local, ci in enumerate(contig_ids):
        lo, hi = int(shard.contig_offsets[ci]), int(shard.contig_offsets[ci + 1])
        sub_parts.append(
            (
                shard.hash_pos_order[lo:hi],
                shard.wpos[lo:hi],
                shard.strand[lo:hi],
                local,
            )
        )
        sub.contig_names.append(shard.contig_names[ci])
        sub.contig_lengths.append(shard.contig_lengths[ci])
    sub.finalize(sub_parts)
    return sub
