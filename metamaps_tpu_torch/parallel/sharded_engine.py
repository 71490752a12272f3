"""Spatial sharded mapping as a product path.

Counterpart: ``metamaps_tpu/parallel/sharded_engine.py``. The reference
maps every read against every memory-bounded index shard, concatenates
candidates per read, and only then computes mapping qualities and writes
one unified output + sidecars (mapWrap.h:34-213 unifyFiles, :215-323
addMappingQualities, shard callbacks :380-429). Here the shards are
SPATIAL: the reference index is partitioned into contiguous contig blocks
across the mesh's 'shard' axis, reads are split over the 'data' axis, and
each rank (s, d) holds one ``TorchMapperEngine`` over block s on its
device (sketch + L1 + L2 on the device, the L2 sweep kernel included).
Each block maps the query file through the memory-bounded shard loop's own
writer (``map_query_file_against_shard``) into a temporary file, and the
standard ``unify_files`` finisher merges them per read (the JAX package's
shard-axis ``all_gather``), which gives byte-identical mapping files and
sidecars.

Contiguous block partitioning (not greedy balancing) keeps the per-read
line order of the merged output equal to the single-device run: L1
candidates are emitted in (seqid, position) order, so concatenating shard
outputs in shard order reproduces the global order exactly. Each block has
its own frequency threshold (``SketchShard.finalize``), as in the JAX
package.

The ranks run one after another in the calling thread, block after block,
so the mesh is no faster than one device on any number of cards: it keeps
each block's tables on D devices and maps every read once per block.
"""
from __future__ import annotations

import sys
import time
from typing import List, Sequence, Tuple

import numpy as np

from ..engine.index import SketchShard, build_shards
from ..engine.mapper_oracle import ReadMapping
from ..engine.mapper_torch import TorchMapperEngine
from ..engine.mapwrap import (STAT_KEYS, map_query_file_against_shard,
                              unify_query_file)
from ..params import Parameters
from .mesh import make_mesh_2d
from .sharded_map import sub_shard


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """Parse 'shard=S,data=D' (either key optional, default 1)."""
    vals = {"shard": 1, "data": 1}
    for part in spec.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in vals:
            raise ValueError(f"unknown mesh axis {k!r} (want shard=, data=)")
        vals[k] = int(v)
    if vals["shard"] < 1 or vals["data"] < 1:
        raise ValueError("mesh axes must be >= 1")
    return vals["shard"], vals["data"]


def partition_contigs_blocks(shard: SketchShard, n_parts: int) -> List[SketchShard]:
    """Split one host index into n_parts CONTIGUOUS contig blocks, balanced
    by minimizer count (the same shape as the reference's sequential
    memory-budget shard cuts, winSketch.hpp:298-329). Contiguity preserves
    global (seqid, pos) candidate order across the shard-order merge.
    Shard-local seqids restart at 0 per block."""
    n_contigs = len(shard.contig_names)
    sizes = np.asarray(
        [
            int(shard.contig_offsets[i + 1] - shard.contig_offsets[i])
            for i in range(n_contigs)
        ],
        dtype=np.int64,
    )
    total = int(sizes.sum())
    # cut after the contig whose cumulative load crosses i/n_parts of total
    cuts = [0]
    csum = np.cumsum(sizes)
    for i in range(1, n_parts):
        target = total * i / n_parts
        pos = int(np.searchsorted(csum, target, side="left")) + 1
        pos = max(pos, cuts[-1])  # keep monotone; empty blocks allowed
        pos = min(pos, n_contigs)
        cuts.append(pos)
    cuts.append(n_contigs)
    return [sub_shard(shard, list(range(cuts[b], cuts[b + 1])))
            for b in range(n_parts)]


def _summed_stats(engines) -> dict:
    """The engines' counters and phase seconds, summed."""
    out = {key: sum(e.stats[key] for e in engines) for key in STAT_KEYS}
    phase_s: dict = {}
    for e in engines:
        for k, v in e.stats["phase_s"].items():
            phase_s[k] = phase_s.get(k, 0.0) + v
    out["phase_s"] = phase_s
    return out


class _DataRow:
    """The D data ranks of one contig block, as one engine: the reads,
    ordered by length so that a rank's rows share its length buckets, go
    in row blocks of ``rows_per_device``, block k to rank k mod D (each
    global chunk of ``rows_per_device * D`` reads is cut into D contiguous
    row blocks). Results are in input order."""

    def __init__(self, engines: List[TorchMapperEngine], rows_per_device: int):
        self.engines = engines
        self.rows_per_device = rows_per_device

    @property
    def stats(self) -> dict:
        return _summed_stats(self.engines)

    def map_reads(self, seqs: List[np.ndarray]) -> List[List[ReadMapping]]:
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        R, D = self.rows_per_device, len(self.engines)
        out: List[List[ReadMapping]] = [None] * len(seqs)
        for k, lo in enumerate(range(0, len(order), R)):
            rows = order[lo:lo + R]
            maps = self.engines[k % D].map_reads([seqs[i] for i in rows])
            for i, m in zip(rows, maps):
                out[i] = m
        return out


class ShardedMapperEngine:
    """Maps read batches against a contig-partitioned index on a
    ('shard', 'data') mesh of torch devices; :meth:`map_reads` returns
    per-SHARD per-read mapping lists so the caller can keep the reference's
    per-shard output files + unifyFiles contract.

    Rank (s, d) holds a ``TorchMapperEngine`` over block s on its device,
    so each block's tables are on the D devices of its row, as ``P(shard)``
    replicates them over the data axis in JAX; ``rows[s]`` is block s's
    row of ranks as one engine. ``devices`` lists the S * D rank devices
    (rank s * D + d; a device may repeat); by default ``cuda:0 ..
    cuda:S*D-1``, raising with fewer cards. ``read_len_buckets`` (default
    the engine's own ladder) and ``profile`` go to every rank's engine."""

    def __init__(self, full_shard: SketchShard, params: Parameters,
                 n_shard: int, n_data: int,
                 read_len_buckets: Sequence[int] = None,
                 rows_per_device: int = 32, devices=None,
                 profile: bool = False):
        self.mesh = make_mesh_2d(n_shard, n_data, devices)
        self.parts = partition_contigs_blocks(full_shard, n_shard)
        self.engines = [
            [TorchMapperEngine(self.parts[s], params,
                               device=self.mesh.devices[s, d],
                               read_len_buckets=read_len_buckets,
                               profile=profile)
             for d in range(n_data)]
            for s in range(n_shard)
        ]
        self.rows = [_DataRow(row, rows_per_device) for row in self.engines]

    @property
    def stats(self) -> dict:
        """The ranks' engine counters summed, and their phase seconds."""
        return _summed_stats([e for row in self.engines for e in row])

    def map_reads(self, seqs: List[np.ndarray]) -> List[List[List[ReadMapping]]]:
        """Returns results[shard][read] = list of ReadMapping (unfiltered;
        caller applies report_filter per shard), in input read order."""
        return [row.map_reads(seqs) for row in self.rows]


def map_query_file_sharded(engine: ShardedMapperEngine, params: Parameters,
                           query: str, prefix: str, engine_stats: dict = None,
                           profile: bool = False):
    """Map every long-enough read of ``query`` on each block of ``engine``
    with the shard loop's writer into ``prefix.{s}``, then unify them into
    ``prefix`` and its sidecars, which removes the per-block files.
    ``engine_stats`` sums each block's counters, as the shard loop of
    ``map_directly`` does; ``profile`` prints each block's phase seconds."""
    files = [f"{prefix}.{s}" for s in range(len(engine.parts))]
    for part, row, path in zip(engine.parts, engine.rows, files):
        map_query_file_against_shard(part, params, query, path,
                                     engine_stats=engine_stats,
                                     profile=profile, mapper=row)
    unify_query_file(prefix, query, params, files)


def map_directly_sharded(params: Parameters, n_shard: int, n_data: int,
                         read_len_buckets: Sequence[int] = None,
                         rows_per_device: int = None,
                         progress: bool = False, devices=None,
                         engine_stats: dict = None, profile: bool = False):
    """mapDirectly over a device mesh: one full index built and partitioned
    spatially, each block's outputs unified with the standard unify_files +
    add_mapping_qualities host finisher — byte-identical files and
    sidecars (mapWrap.h:34-213,215-323 contract with shards in space
    instead of time). Supports comma-separated query/output lists
    (:func:`map_query_file_sharded` per file).

    ``read_len_buckets`` / ``rows_per_device`` override the engine's read
    buckets and rows per rank; ``devices`` the rank devices (default
    ``cuda:0 .. cuda:S*D-1``). ``progress`` prints time-stamped phase lines
    to stderr; ``engine_stats`` and ``profile`` as in
    :func:`map_query_file_sharded`."""
    _t0 = time.time()

    def _p(msg):
        if progress:
            print(f"[mesh {time.time() - _t0:6.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    prefixes = params.out_file_name.split(",")
    queries = (
        params.query_sequences[0].split(",")
        if len(params.query_sequences) == 1
        else params.query_sequences
    )
    assert len(prefixes) == len(queries)

    shards: List[SketchShard] = []
    _p("building index")
    build_shards(params, 0, lambda s, n: shards.append(s))
    assert len(shards) == 1
    _p(f"index built ({shards[0].n_minimizers} minimizers); "
       f"partitioning over shard={n_shard}, data={n_data}")
    kw = {}
    if rows_per_device is not None:
        kw["rows_per_device"] = int(rows_per_device)
    engine = ShardedMapperEngine(shards[0], params, n_shard, n_data,
                                 read_len_buckets=read_len_buckets,
                                 devices=devices, profile=profile, **kw)
    _p("engine ready (each block's tables on its ranks' devices)")
    for prefix, query in zip(prefixes, queries):
        map_query_file_sharded(engine, params, query, prefix,
                               engine_stats=engine_stats, profile=profile)
        _p(f"unified {prefix}")
