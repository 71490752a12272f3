"""Mapping orchestration: shard loop, per-read merge, mapping qualities.

Counterpart: ``metamaps_tpu/engine/mapwrap.py``. :func:`add_mapping_qualities`
and :func:`unify_files` are jax-free copies (the JAX module imports ``jax``
through its index and oracle modules); :func:`map_query_file_against_shard`,
:func:`map_directly` and :func:`map_against_index` are copies with the
port's engine kinds: ``torch`` (the batched engine on an explicit device)
and ``oracle`` (the serial host engine). There is no ``auto``: without a
CUDA device the torch engine raises instead of quietly running the host
oracle.
"""
from __future__ import annotations

import math
import os
import sys
import time
from typing import List

import numpy as np

from metamaps_tpu_torch import stats, trace
from metamaps_tpu_torch.io.fasta import read_sequences
from metamaps_tpu_torch.io.mappings import (
    MappingLine,
    fmt_g,
    write_meta,
    write_parameters_file,
    write_unmapped_lengths,
)
from metamaps_tpu_torch.params import Parameters

from . import mapper_oracle
from .index import SketchShard, build_shards, load_index_manifest

ENGINES = ("torch", "oracle")
#: reads handed to the torch engine at a time, and mapped reads whose
#: mapping qualities unify computes together
BATCH_READS = 8192
#: the torch engine's counters that ``engine_stats`` sums
STAT_KEYS = ("oracle_fallbacks", "l2_candidates", "l2_slabs")


def add_mapping_qualities(params: Parameters, lines: List[str]) -> List[str]:
    """Append correctedIdentity and mappingQuality to each mapping line of
    one read (mapWrap.h:215-323)."""
    if not lines:
        return lines
    return _with_mapping_qualities(params, [lines])


def _with_mapping_qualities(params: Parameters,
                            reads: List[List[str]]) -> List[str]:
    """:func:`add_mapping_qualities` of many reads, each a non-empty list of
    its mapping lines: their lines, in order, each with correctedIdentity
    and mappingQuality appended. The likelihoods of all lines come from one
    :func:`stats.likelihood_observed_set_sizes_batch` call; each read's
    total is Python's ``sum`` over its lines, as the reference's loop
    adds them."""
    k = params.kmer_size
    names, identities, intersections, sketches = [], [], [], []
    n_kmers, best = [], []  # per line, of its read
    for lines in reads:
        name = lines[0].split(" ", 1)[0]
        names.append(name)
        read_ids = set()
        read_lengths = set()
        max_identity = -1.0
        for line in lines:
            fields = line.split(" ")
            if len(fields) not in (12, 14, 15):
                raise ValueError(f"read {name}: a mapping line of "
                                 f"{len(fields)} fields: {line!r}")
            read_ids.add(fields[0])
            read_lengths.add(int(fields[1]))
            identity = float(fields[9]) / 100.0
            intersection = int(fields[10])
            sketch = int(fields[11])
            if intersection > sketch:
                raise ValueError(f"read {name}: intersection {intersection} "
                                 f"above sketch size {sketch}")
            max_identity = max(max_identity, identity)
            identities.append(identity)
            intersections.append(intersection)
            sketches.append(sketch)
        if len(read_ids) != 1 or len(read_lengths) != 1:
            raise ValueError(f"read {name}: one read's lines name read IDs "
                             f"{sorted(read_ids)} and lengths "
                             f"{sorted(read_lengths)}")
        read_length = read_lengths.pop()
        if read_length <= k:
            raise ValueError(f"read {name}: length {read_length} not above "
                             f"the k-mer size {k}")
        n_kmers += [read_length - k + 1] * len(lines)
        best += [math.exp(-(1 - max_identity))] * len(lines)

    likelihoods = stats.likelihood_observed_set_sizes_batch(
        k, n_kmers, best, sketches, intersections)
    out = []
    at = 0
    for name, lines in zip(names, reads):
        end = at + len(lines)
        total = sum(likelihoods[at:end])
        if not total > 0:
            raise ValueError(f"zero likelihood sum for read {name}")
        for line, lh, identity in zip(lines, likelihoods[at:end],
                                      identities[at:end]):
            corrected = np.float32(math.exp(-(1 - identity)))
            out.append(line + f" {fmt_g(np.float32(corrected * 100))} "
                              f"{fmt_g(lh / total)}")
        at = end
    return out


class _ShardOutputReader:
    """Sequential per-read access to a per-shard mapping file (mirrors
    queryOpenFileForReadData, mapWrap.h:53-94: lines for one read are
    consecutive and in query order)."""

    def __init__(self, path: str):
        self._f = open(path)
        self._pushback = None

    def lines_for(self, read_id: str) -> List[str]:
        out = []
        while True:
            if self._pushback is not None:
                line = self._pushback
                self._pushback = None
            else:
                raw = self._f.readline()
                if not raw:
                    return out
                line = raw.rstrip("\n")
            pos = line.find(" ")
            if pos < 0:
                return out
            if line[:pos] == read_id:
                out.append(line)
            else:
                self._pushback = line
                return out

    def exhausted(self) -> bool:
        if self._pushback is not None:
            return False
        pos = self._f.tell()
        more = self._f.readline()
        self._f.seek(pos)
        return not more

    def close(self):
        self._f.close()


def unify_files(
    unified_fn: str,
    params: Parameters,
    mapping_files: List[str],
    query_sequences: List[str],
):
    """Merge per-shard outputs per read, compute mapping qualities, write
    sidecars (mapWrap.h:34-213). The merged lines of up to
    :data:`BATCH_READS` mapped reads at a time get their mapping qualities
    together (:func:`_with_mapping_qualities`). A root ``unify`` span
    (:mod:`trace`) with ``file``, the mappable ``reads`` merged, the
    ``lines`` written, ``mapq_batches``, the number of such batches, and
    ``mapq_s``, the seconds spent computing their mapping qualities."""
    with trace.span("unify", file=unified_fn) as sp:
        readers = [_ShardOutputReader(p) for p in mapping_files]
        processed = set()

        total_reads = 0
        n_mapped = 0
        n_too_short = 0
        n_not_mapped = 0
        n_lines = 0
        mapq_ns = 0
        n_batches = 0
        unmapped_entries = []
        pending = []  # the merged lines of each mapped read not yet written

        def flush(out):
            nonlocal mapq_ns, n_batches, n_lines
            t = time.perf_counter_ns()
            lines = _with_mapping_qualities(params, pending)
            mapq_ns += time.perf_counter_ns() - t
            n_batches += 1
            n_lines += len(lines)
            out.writelines(line + "\n" for line in lines)
            pending.clear()

        with open(unified_fn, "w") as out:
            for qsf in query_sequences:
                for name, seq in read_sequences(qsf):
                    total_reads += 1
                    length = len(seq)
                    if (
                        length < params.window_size
                        or length < params.kmer_size
                        or length < params.min_read_length
                    ):
                        n_too_short += 1
                        continue
                    if name in processed:
                        raise RuntimeError(f"read ID {name} already processed")
                    combined = []
                    for r in readers:
                        combined.extend(r.lines_for(name))
                    if not combined:
                        n_not_mapped += 1
                        unmapped_entries.append((length, name))
                    else:
                        n_mapped += 1
                        pending.append(combined)
                        if len(pending) >= BATCH_READS:
                            flush(out)
                    processed.add(name)
            if pending:
                flush(out)

        reads_mappable = total_reads - n_too_short
        for i, r in enumerate(readers):
            if not r.exhausted() and reads_mappable != 0:
                raise RuntimeError(
                    f"shard output {mapping_files[i]} not completely consumed"
                )
            r.close()

        write_meta(unified_fn, total_reads, n_too_short, n_mapped, n_not_mapped)
        write_unmapped_lengths(unified_fn, unmapped_entries)
        for p in mapping_files:
            os.remove(p)
        write_parameters_file(unified_fn, params)
        sp.set(reads=reads_mappable, lines=n_lines, mapq_batches=n_batches,
               mapq_s=mapq_ns * 1e-9)


def unify_query_file(prefix: str, query: str, params: Parameters,
                     mapping_files: List[str]):
    """:func:`unify_files` of one query file's per-shard outputs into
    ``prefix``, with ``params`` naming that file and that output."""
    local = Parameters(**{**params.__dict__})
    local.query_sequences = [query]
    local.out_file_name = prefix
    unify_files(prefix, local, mapping_files, [query])


def map_query_file_against_shard(
    shard: SketchShard,
    params: Parameters,
    query_file: str,
    out_path: str,
    engine: str = "torch",
    device="cuda",
    engine_stats: dict = None,
    profile: bool = False,
    mapper=None,
):
    """skch::Map equivalent: map every (long-enough) read of one file
    against one shard, writing 12-field lines in read order
    (computeMap.hpp:104-172 + reportReadMappings). ``engine_stats``, when
    given, accumulates the torch engine's counters; ``profile`` has the
    torch engine time its phases on the card by CUDA events (see
    :class:`TorchMapperEngine`) and prints its ``stats["phase_s"]`` on
    stderr. ``mapper``, when given, is a built engine over ``shard``
    (``map_reads`` and ``stats`` as :class:`TorchMapperEngine` has them)
    used in place of a new one; its counters count from where they stand
    at the call.

    A root ``mapfile`` span (:mod:`trace`) around reading, mapping and
    writing, with ``file`` (``out_path``), ``reads_total`` and
    ``mappable``; inside it, for each batch of up to :data:`BATCH_READS`
    reads, a ``mapfile.parse`` span (FASTQ reading and length filtering),
    the engine's ``engine.map_reads``, and a ``mapfile.write`` span (report
    filter, line format and write)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown mapping engine {engine!r}; one of {ENGINES}")
    torch_engine = mapper
    if engine == "torch" and torch_engine is None:
        from .mapper_torch import TorchMapperEngine

        torch_engine = TorchMapperEngine(shard, params, device=device,
                                         profile=profile)
    before = _counters(torch_engine)

    t_start = time.perf_counter()
    n_mapped = 0
    n_picked = 0
    n_total = 0

    def emit(out, name, mappings):
        nonlocal n_mapped
        mappings = mapper_oracle.report_filter(mappings, params.report_all)
        if mappings:
            n_mapped += 1
        for m in mappings:
            ml = MappingLine(
                read_id=name,
                read_len=m.query_len,
                strand=m.strand,
                contig_id=shard.contig_names[m.ref_seqid],
                contig_len=shard.contig_lengths[m.ref_seqid],
                ref_start=m.ref_start,
                ref_end=m.ref_end,
                identity=m.nuc_identity,
                intersection=m.conserved,
                sketch_size=m.sketch_size,
            )
            out.write(ml.format() + "\n")

    def map_batch(seqs):
        if torch_engine is None:
            return [mapper_oracle.map_read(shard, params, s) for s in seqs]
        return torch_engine.map_reads(seqs)

    with trace.span("mapfile", file=out_path) as file_span, \
            open(out_path, "w") as out:
        reads = read_sequences(query_file)
        more = True
        while more:
            pending = []  # (name, seq) batch for the engine
            with trace.span("mapfile.parse"):
                for name, seq in reads:
                    n_total += 1
                    if (
                        len(seq) < params.window_size
                        or len(seq) < params.kmer_size
                        or len(seq) < params.min_read_length
                    ):
                        continue
                    n_picked += 1
                    pending.append((name, seq))
                    if len(pending) >= BATCH_READS:
                        break
                else:
                    more = False
            if pending:
                mappings = map_batch([s for _, s in pending])
                with trace.span("mapfile.write"):
                    for (name, _), ms in zip(pending, mappings):
                        emit(out, name, ms)
        file_span.set(reads_total=n_total, mappable=n_picked)
    fallbacks = ""
    if torch_engine is not None:
        after = _counters(torch_engine)
        es = {k: after[k] - before[k] for k in STAT_KEYS}
        phase_s = {k: v - before["phase_s"].get(k, 0.0)
                   for k, v in after["phase_s"].items()}
        fallbacks = f" oracle_fallbacks={es['oracle_fallbacks']}"
        if engine_stats is not None:
            for key in STAT_KEYS:
                engine_stats[key] = engine_stats.get(key, 0) + es[key]
            engine_stats["minhits_s"] = (engine_stats.get("minhits_s", 0.0)
                                         + phase_s.get("minhits", 0.0))
        if profile:
            print(f"INFO, metamaps_tpu_torch::map, phase seconds for "
                  f"{out_path}: " + " ".join(
                      f"{k}={v:.3f}" for k, v in phase_s.items()),
                  file=sys.stderr)
    if engine_stats is not None:
        for key, val in (("reads_total", n_total), ("reads_mappable", n_picked),
                         ("reads_mapped", n_mapped),
                         ("map_s", time.perf_counter() - t_start)):
            engine_stats[key] = engine_stats.get(key, 0) + val
    # the reference's mapping wall-clock print (computeMap.hpp:91-96)
    print(
        f"INFO, metamaps_tpu_torch::map, time spent mapping {query_file}: "
        f"{time.perf_counter() - t_start:.2f} s "
        f"[engine={engine}, reads total={n_total} mappable={n_picked} "
        f"mapped={n_mapped}{fallbacks}]",
        file=sys.stderr,
    )
    return n_mapped, n_picked, n_total


def _counters(torch_engine) -> dict:
    """A copy of the engine's counters and phase seconds (empty without an
    engine)."""
    if torch_engine is None:
        return {}
    es = torch_engine.stats
    return dict({k: es[k] for k in STAT_KEYS}, phase_s=dict(es["phase_s"]))


def map_directly(params: Parameters, maximum_memory: int = 0, device="cuda",
                 engine_stats: dict = None, profile: bool = False):
    """mapDirectly: build shards and map in the same pass
    (mapWrap.h:407-441). Supports comma-separated query/output lists."""
    prefixes = params.out_file_name.split(",")
    queries = params.query_sequences[0].split(",") if len(params.query_sequences) == 1 else params.query_sequences
    assert len(prefixes) == len(queries)

    per_file_outputs: List[List[str]] = [[] for _ in prefixes]

    def map_shard(shard: SketchShard, n: int):
        for fi, (prefix, query) in enumerate(zip(prefixes, queries)):
            out_fn = f"{prefix}.{n}"
            map_query_file_against_shard(
                shard, params, query, out_fn, engine=params.engine,
                device=device, engine_stats=engine_stats, profile=profile,
            )
            per_file_outputs[fi].append(out_fn)

    build_shards(params, maximum_memory, map_shard)

    for fi, (prefix, query) in enumerate(zip(prefixes, queries)):
        unify_query_file(prefix, query, params, per_file_outputs[fi])


def map_against_index(params: Parameters, index_prefix: str, device="cuda",
                      engine_stats: dict = None, profile: bool = False):
    """mapAgainstIndex: restore serialized shards and map
    (mapWrap.h:443-554). Parameters stored with the index override the
    sketch-related CLI parameters. Each shard is loaded from its stored
    tables in manifest order and every query file mapped against it with a
    fresh engine, which drops its device tables before the next shard is
    loaded. ``engine_stats``, when given, also collects the seconds of each
    shard's load (``shard_load_s``)."""
    from ..io.mappings import read_parameters_file

    shard_files = load_index_manifest(index_prefix)
    stored = read_parameters_file(index_prefix)

    use = Parameters(**{**params.__dict__})
    use.alphabet_size = int(stored["alphabetSize"])
    use.kmer_size = int(stored["kmerSize"])
    use.min_read_length = int(stored["minReadLength"])
    use.p_value = float(stored["p_value"])
    use.percentage_identity = float(stored["percentageIdentity"])
    use.window_size = int(stored["windowSize"])
    use.reference_size = int(stored["referenceSize"])

    prefixes = params.out_file_name.split(",")
    queries = params.query_sequences[0].split(",") if len(params.query_sequences) == 1 else params.query_sequences
    assert len(prefixes) == len(queries)

    per_file_outputs: List[List[str]] = [[] for _ in prefixes]
    for shard_i, sf in enumerate(shard_files):
        t0 = time.perf_counter()
        shard = SketchShard.load(sf)
        load_s = time.perf_counter() - t0
        print(f"INFO, metamaps_tpu_torch::index, shard {shard_i} loaded from "
              f"{sf} in {load_s:.2f} s: {len(shard.contig_names)} sequences, "
              f"{shard.n_minimizers} minimizers", file=sys.stderr)
        if engine_stats is not None:
            engine_stats.setdefault("shard_load_s", []).append(load_s)
        for fi, (prefix, query) in enumerate(zip(prefixes, queries)):
            # 0-based shard numbers here, 1-based in map_directly, as in the
            # JAX package
            out_fn = f"{prefix}.{shard_i}"
            map_query_file_against_shard(
                shard, use, query, out_fn, engine=params.engine,
                device=device, engine_stats=engine_stats, profile=profile,
            )
            per_file_outputs[fi].append(out_fn)

    for fi, (prefix, query) in enumerate(zip(prefixes, queries)):
        unify_query_file(prefix, query, use, per_file_outputs[fi])
