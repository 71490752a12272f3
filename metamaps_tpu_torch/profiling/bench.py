"""Mapping throughput of the port on a structured 1 Gbp database.

Counterpart of the repo's root ``bench.py``, with its seeds, read mix and
keys: a database from ``synth_structured_db`` (seed 20260820; duplicated
genomes, homologous segments, and repeat families dense enough that the
frequency threshold binds), 16,384 ONT-like reads of 3000-7600 bp cut at
8192, k 16, w 16, ``--pi 80``, ``--minReadLen 2000``, ``--all``. The
engine is :class:`TorchMapperEngine` over the bench's read-length buckets
with the L1 hit capacity raised to 16,384, as there. It prints one JSON
line ``{"metric": "mapping_throughput", "value": reads/s, "unit":
"reads/s/card", "detail": {...}}`` after the mapping passes and again after
the EM rounds (one round on 1M synthetic lines, and one on the run's own
union tiled to at least 5M lines over at least 1000 taxa, each held to the
host float64 round).

The index is built once (winnowing on a thread pool, then
``SketchShard.finalize``) and cached under ``.bench_cache/torch/`` as a
stored index in the layout ``index`` writes (``DB.index``,
``DB.parameters``, ``DB.1.npz``), so ``mapAgainstIndex`` reads it as it
is; the reads beside it as an ``npz``. A cache that does not load is
rebuilt. Left out, as the port has no use for them: the JAX bench's table
caches and their migrations, its frozen plans (``bench_plans.json``) and
the common padded shapes of its multi-shard loop (each shard's engine here
takes the shard's own shapes).

    python -m metamaps_tpu_torch.profiling.bench                # 1 Gbp on cuda
    python -m metamaps_tpu_torch.profiling.bench --quick --device cpu
    python -m metamaps_tpu_torch.profiling.bench --shards 2     # 2 x 1 Gbp
    python -m metamaps_tpu_torch.profiling.bench --prebuild-shards 2
    python -m metamaps_tpu_torch.profiling.bench --dump-mappings out/bench
"""
from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from ..device import require_cuda
from ..engine import mapper_oracle
from ..engine.em import MappingTable, load_mapping_table
from ..engine.index import SketchShard, load_index_manifest
from ..engine.mapper_torch import TorchMapperEngine
from ..engine.mapwrap import add_mapping_qualities
from ..io.mappings import (MappingLine, write_meta, write_parameters_file,
                           write_unmapped_lengths)
from ..ops import l2_sweep
from ..ops.tables import device_tables
from ..ops.winnow import winnow_fast
from ..params import Parameters
from ..sim.synth_db import make_ont_reads, synth_structured_db
from ..taxonomy import extract_taxon_id
from . import em_bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, ".bench_cache", "torch")
CACHE_FORMAT = 1  # bump when the cache's layout changes
LARGE_BASES = 1_000_000_000
LARGE_SEED = 20260820
SHARD_SEED_STEP = 7919  # shard i of the multi-shard bench: seed + 7919 i
N_READS = 16384
QUICK_READS = 512
# the read-length ladder over the bench's 3000-8192 bp reads
BENCH_BUCKETS = (3072, 4096, 5120, 6144, 7168, 8192)
HITS_MAX = 16384  # L1 hit capacity of every bucket (bench.py:1106)
READ_MIN, READ_MAX, READ_CUT = 3000, 7600, 8192
EM_SYNTH_LINES = 1_000_000
EM_REALDIST_LINES = 5_000_000
EM_REALDIST_TAXA = 1000
EM_REPS = 10
# the sweep kernels whose launches a pass counts
SWEEPS = (l2_sweep.l2_event_sweep_batch, l2_sweep.l2_event_sweep_wide)
# what a cache read can raise when the files are missing, cut or stale
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, RuntimeError,
               zipfile.BadZipFile)


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def bench_params() -> Parameters:
    """k 16, w 16, ``--minReadLen 2000``, ``--pi 80``, ``--all``."""
    return Parameters(kmer_size=16, window_size=16, min_read_length=2000,
                      percentage_identity=80.0, report_all=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def synth_genomes(total_bases: int, seed: int):
    """(rng, genomes, contig names) of the structured database; the reads
    are drawn from ``rng`` after the genomes."""
    rng = np.random.default_rng(seed)
    genomes, names = synth_structured_db(rng, total_bases=total_bases)
    return rng, genomes, names


def draw_reads(rng, genomes, n_reads: int) -> List[np.ndarray]:
    """The bench's ONT-like reads, each cut at 8192 (``max_len`` leaves room
    for the insertion stretch under the 8192 bucket). The reads come one
    after another from ``rng``, so the first n of a larger draw are a draw
    of n."""
    reads = make_ont_reads(rng, genomes, n_reads, min_len=READ_MIN,
                           max_len=READ_MAX)
    return [r[:READ_CUT] for r in reads]


def build_shard(genomes, names, params: Parameters, info: dict,
                threads: int = None) -> SketchShard:
    """Winnow every genome on a thread pool (the native winnower releases
    the interpreter lock), then ``SketchShard.finalize``: one shard, the
    one ``index`` stores for the same genomes."""
    threads = threads or max(2, os.cpu_count() or 2)
    k, w = params.kmer_size, params.window_size
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        outs = list(ex.map(lambda g: winnow_fast(g, k, w), genomes))
    info["winnow_s"] = time.perf_counter() - t0
    shard = SketchShard()
    parts = []
    for i, (g, (h, p, s)) in enumerate(zip(genomes, outs)):
        parts.append((h, p, s, i))
        shard.contig_names.append(names[i])
        shard.contig_lengths.append(len(g))
    t0 = time.perf_counter()
    shard.finalize(parts)
    info["finalize_s"] = time.perf_counter() - t0
    return shard


def build_db_quick(rng, n_genomes: int = 2, genome_len: int = 1_000_000):
    """``bench.py --quick``'s database: uniform random genomes, one shard."""
    shard = SketchShard()
    parts = []
    genomes = []
    for i in range(n_genomes):
        g = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                       size=genome_len)
        genomes.append(g)
        h, p, s = winnow_fast(g, 16, 16)
        parts.append((h, p, s, i))
        shard.contig_names.append(f"C{i}|kraken:taxid|{1000 + i}|B{i}.1")
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    return genomes, shard


def make_reads_quick(rng, genomes, n_reads: int, min_len: int = 3000,
                     max_len: int = 8000, sub: float = 0.10):
    """``bench.py --quick``'s reads: slices with substitutions only."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for _ in range(n_reads):
        g = genomes[rng.integers(0, len(genomes))]
        n = int(rng.integers(min_len, max_len))
        pos = int(rng.integers(0, len(g) - n))
        r = g[pos:pos + n].copy()
        nmut = int(sub * n)
        idx = rng.integers(0, n, nmut)
        r[idx] = bases[rng.integers(0, 4, nmut)]
        reads.append(r)
    return reads


def write_db_fasta(path: str, genomes, names) -> None:
    """The genomes as a FASTA in lines of 10,000 bases."""
    with open(path, "w") as f:
        for g, name in zip(genomes, names):
            f.write(f">{name}\n")
            s = g.tobytes().decode()
            for j in range(0, len(s), 10000):
                f.write(s[j:j + 10000] + "\n")


def write_fastq(path: str, reads, first: int = 0) -> None:
    """The reads as ``read{first}``, ``read{first + 1}``, ... with a
    constant quality."""
    with open(path, "w") as f:
        for i, seq in enumerate(reads, first):
            s = seq.tobytes().decode()
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


# ---------------------------------------------------------------------------
# the disk cache: a stored index and the reads
# ---------------------------------------------------------------------------

def cache_prefix(cache_dir: str, total_bases: int, seed: int) -> str:
    """The stored index's prefix (``mapAgainstIndex --index``)."""
    return os.path.join(cache_dir, f"db_{total_bases}_{seed}", "DB")


def _reads_path(cache_dir: str, total_bases: int, seed: int, n: int) -> str:
    return os.path.join(cache_dir, f"reads_{total_bases}_{seed}_{n}.npz")


def _find_reads(cache_dir: str, total_bases: int, seed: int, n_reads: int):
    """The cached read set of the fewest reads >= ``n_reads``, or None."""
    best, best_n = None, None
    for path in glob.glob(_reads_path(cache_dir, total_bases, seed, "*")):
        try:
            n = int(path.rsplit("_", 1)[1].split(".")[0])
        except ValueError:
            continue
        if n >= n_reads and (best_n is None or n < best_n):
            best, best_n = path, n
    return best


def write_replace(path: str, write) -> None:
    """``write(tmp)`` to a temporary name beside ``path``, then move it into
    place: a cut run leaves no partial file under the real name."""
    tmp = path + ".tmp" + os.path.splitext(path)[1]
    write(tmp)
    os.replace(tmp, path)


def save_reads(path: str, reads) -> None:
    lens = np.array([len(r) for r in reads], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    seq = np.concatenate(reads) if reads else np.zeros(0, np.uint8)
    write_replace(path, lambda tmp: np.savez(tmp, seq=seq, offsets=offsets))


def load_reads(path: str, n_reads: int) -> List[np.ndarray]:
    with np.load(path) as z:
        seq, offsets = z["seq"], z["offsets"]
    if offsets.size - 1 < n_reads:
        raise ValueError(f"{path} holds {offsets.size - 1} reads")
    return [seq[offsets[i]:offsets[i + 1]] for i in range(n_reads)]


def _stamp_path(prefix: str) -> str:
    return prefix + ".bench.json"


def save_index(prefix: str, shard: SketchShard, params: Parameters,
               total_bases: int, seed: int) -> None:
    """Store ``shard`` as ``index`` does (``<prefix>.1.npz``,
    ``<prefix>.parameters``, the manifest ``<prefix>.index``), then the
    cache's stamp, which a load checks first; each file goes through a
    temporary name."""
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    stamp = _stamp_path(prefix)
    if os.path.exists(stamp):
        os.remove(stamp)
    npz = prefix + ".1.npz"
    write_replace(npz, shard.save)
    p = Parameters(**{**params.__dict__})
    p.index = prefix
    p.reference_size = int(sum(shard.contig_lengths))
    write_parameters_file(prefix, p)

    def text(s):
        def write(tmp):
            with open(tmp, "w") as f:
                f.write(s)
        return write

    write_replace(prefix + ".index", text(f"1\n{npz}\n"))
    write_replace(stamp, text(json.dumps({
        "format_version": CACHE_FORMAT, "total_bases": total_bases,
        "seed": seed, "n_minimizers": shard.n_minimizers})))


def _stamp_ok(prefix: str, total_bases: int, seed: int) -> dict:
    """The cache's stamp; raises where it is missing, unreadable or of
    another format, size or seed."""
    with open(_stamp_path(prefix)) as f:
        stamp = json.load(f)
    if (stamp.get("format_version"), stamp.get("total_bases"),
            stamp.get("seed")) != (CACHE_FORMAT, total_bases, seed):
        raise ValueError(f"{prefix}: cache stamp {stamp}")
    return stamp


def load_index(prefix: str, total_bases: int, seed: int) -> SketchShard:
    """The cached shard (``SketchShard.load``); raises one of the
    unreadable-cache errors where it does not load."""
    stamp = _stamp_ok(prefix, total_bases, seed)
    files = load_index_manifest(prefix)
    if len(files) != 1:
        raise ValueError(f"{prefix}: {len(files)} stored shards")
    shard = SketchShard.load(files[0])
    if shard.n_minimizers != stamp["n_minimizers"]:
        raise ValueError(f"{prefix}: {shard.n_minimizers} minimizers, "
                         f"stamp {stamp['n_minimizers']}")
    return shard


def _cached_reads(cache_dir, total_bases, seed, n_reads):
    """The first ``n_reads`` cached reads, or None."""
    path = _find_reads(cache_dir, total_bases, seed, n_reads)
    if path is None:
        return None
    try:
        return load_reads(path, n_reads)
    except _UNREADABLE as e:
        log(f"reads cache {path} unreadable ({e!r}); drawing anew")
        return None


def build_db_large(total_bases: int = LARGE_BASES, n_reads: int = N_READS,
                   seed: int = LARGE_SEED, cache_dir: str = CACHE_DIR,
                   threads: int = None):
    """(shard, reads, info): the structured database's shard and reads,
    loaded from the cache where it holds them, else built and stored (the
    reads alone are drawn anew, from re-synthesised genomes, where only
    they are missing). ``info`` has the seconds of each step and
    ``cache`` ("hit" or "miss", the index's)."""
    params = bench_params()
    prefix = cache_prefix(cache_dir, total_bases, seed)
    info: dict = {}
    shard = None
    t0 = time.perf_counter()
    try:
        shard = load_index(prefix, total_bases, seed)
        info.update(cache="hit", load_s=time.perf_counter() - t0)
    except _UNREADABLE as e:
        if os.path.exists(os.path.dirname(prefix)):
            log(f"index cache {prefix} unreadable ({e!r}); rebuilding")
    t0 = time.perf_counter()
    reads = _cached_reads(cache_dir, total_bases, seed, n_reads)
    if reads is not None:
        info["reads_load_s"] = time.perf_counter() - t0
        if shard is not None:
            return shard, reads, info

    t0 = time.perf_counter()
    rng, genomes, names = synth_genomes(total_bases, seed)
    info["synth_s"] = time.perf_counter() - t0
    if shard is None:
        shard = build_shard(genomes, names, params, info, threads)
        t0 = time.perf_counter()
        save_index(prefix, shard, params, total_bases, seed)
        info.update(cache="miss", cache_save_s=time.perf_counter() - t0)
        log(f"index of {total_bases} bp (seed {seed}) stored at {prefix}: "
            f"{shard.n_minimizers} minimizers, frequency threshold "
            f"{shard.freq_threshold}")
    if reads is None:
        t0 = time.perf_counter()
        reads = draw_reads(rng, genomes, n_reads)
        info["reads_s"] = time.perf_counter() - t0
        save_reads(_reads_path(cache_dir, total_bases, seed, n_reads), reads)
    return shard, reads, info


# ---------------------------------------------------------------------------
# mapping
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device: torch.device):
    """The card's name and power limit as ``nvidia-smi`` gives them; None on
    the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_engine(shard, params, device, tables=None) -> TorchMapperEngine:
    return TorchMapperEngine(shard, params, device=device,
                             read_len_buckets=BENCH_BUCKETS, tables=tables,
                             hits_max=HITS_MAX)


def engine_counters(engine: TorchMapperEngine) -> dict:
    """The engine's fallbacks, L2 slabs and candidates, and each sweep
    kernel's launches, as they stand."""
    out = {k: engine.stats[k]
           for k in ("oracle_fallbacks", "l2_slabs", "l2_candidates")}
    out["sweep_launches"] = {fn.__name__: fn.launches for fn in SWEEPS}
    return out


def counters_since(engine: TorchMapperEngine, before: dict) -> dict:
    now = engine_counters(engine)
    out = {k: now[k] - before[k] for k in now if k != "sweep_launches"}
    out["sweep_launches"] = {k: v - before["sweep_launches"][k]
                             for k, v in now["sweep_launches"].items()}
    return out


def warm_up(engine: TorchMapperEngine, reads) -> None:
    """Two passes on a 256-read slice, then one on the full set."""
    for _ in range(2):
        engine.map_reads(reads[:256])
    engine.map_reads(reads)


def run_mapping_bench(engine: TorchMapperEngine, reads, passes: int = 3):
    """:func:`warm_up`, then time ``passes`` full passes, with a
    synchronise before each clock read. Returns (seconds per pass, the last
    pass's results, the last pass's counters)."""
    device = engine.device
    warm_up(engine, reads)
    times = []
    for _ in range(passes):
        before = engine_counters(engine)
        _sync(device)
        t0 = time.perf_counter()
        results = engine.map_reads(reads)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times, results, counters_since(engine, before)


def map_shard_bench(shard, reads, params, device, detail: dict):
    """Upload ``shard``'s tables, build the bench's engine over them and run
    :func:`run_mapping_bench`; fills ``detail`` with the index, table,
    pass and counter numbers, and on a card the peak device bytes while
    the tables are built and while the passes run (the tables plus one
    chunk's transients). Returns (engine, the last pass's results)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tables = device_tables(shard, device)
    _sync(device)
    upload_s = time.perf_counter() - t0
    engine = make_engine(shard, params, device, tables)
    if cuda:
        peak_upload = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    times, results, counts = run_mapping_bench(engine, reads)
    peak_map = torch.cuda.max_memory_allocated(device) if cuda else None
    table_b = tables.nbytes()
    dt_med = float(np.median(times))
    detail.update(
        db_bases=int(sum(shard.contig_lengths)),
        n_minimizers=shard.n_minimizers,
        freq_threshold=int(shard.freq_threshold),
        upload_s=upload_s,
        device_table_gb=table_b / 1e9,
        bytes_per_minimizer=table_b / max(1, shard.n_minimizers),
        **counts,
        n_reads=len(reads),
        n_mapped=sum(1 for r in results if r),
        mean_mappings_per_read=float(np.mean([len(r) for r in results])),
        map_s=dt_med,
        map_s_passes=times,
        map_s_min=min(times),
        map_s_max=max(times),
        reads_per_s_best=len(reads) / min(times),
        peak_device_bytes=max(peak_upload, peak_map) if cuda else None,
        peak_upload_device_bytes=peak_upload if cuda else None,
        peak_map_device_bytes=peak_map,
    )
    return engine, results


def unify_lines(params, all_results, shards, n_reads: int):
    """The unifyFiles merge (mapWrap.h:34-213): per read, the candidates of
    every shard in shard order through the report filter, then mapping
    qualities over the union. Returns (merged mapping lines, n_mapped)."""
    merged_lines = []
    n_mapped = 0
    for r in range(n_reads):
        cands = []
        for i, res in enumerate(all_results):
            for m in mapper_oracle.report_filter(res[r], params.report_all):
                cands.append(MappingLine(
                    read_id=f"read{r}",
                    read_len=m.query_len,
                    strand=m.strand,
                    contig_id=shards[i].contig_names[m.ref_seqid],
                    contig_len=shards[i].contig_lengths[m.ref_seqid],
                    ref_start=m.ref_start,
                    ref_end=m.ref_end,
                    identity=m.nuc_identity,
                    intersection=m.conserved,
                    sketch_size=m.sketch_size,
                ).format())
        if cands:
            n_mapped += 1
            merged_lines.extend(add_mapping_qualities(params, cands))
    return merged_lines, n_mapped


def dump_mappings(fn: str, merged_lines, reads, params, db_bases: int):
    """The merged lines as a mappings file with its ``.meta``,
    ``.meta.unmappedReadsLengths`` and ``.parameters`` sidecars."""
    with open(fn, "w") as f:
        f.write("\n".join(merged_lines) + "\n")
    mapped_ids = {ln.split(" ", 1)[0] for ln in merged_lines}
    write_meta(fn, len(reads), 0, len(mapped_ids),
               len(reads) - len(mapped_ids))
    write_unmapped_lengths(fn, [
        (len(reads[r]), f"read{r}") for r in range(len(reads))
        if f"read{r}" not in mapped_ids])
    p = Parameters(**{**params.__dict__})
    p.reference_size = db_bases
    write_parameters_file(fn, p)


# ---------------------------------------------------------------------------
# EM
# ---------------------------------------------------------------------------

def em_bench_synthetic(rng, device) -> dict:
    """``bench.py``'s ``em_bench``: one round at 1M lines, 250k reads, 5k
    taxa, on ``device`` against the host float64 round (``em_bench``'s
    tolerances: ll within 1e-12 relative, f within 1e-12 absolute; raises
    beyond them)."""
    return em_bench.table_row(em_bench.synthetic_table(rng, EM_SYNTH_LINES),
                              device, EM_REPS)


def tile_table(base: MappingTable, min_lines: int,
               min_taxa: int) -> MappingTable:
    """``base`` repeated in k read blocks to at least ``min_lines`` lines
    (bench.py:833-856): block j keeps every read's lines, mapQ, identities
    and taxon mix, its reads get ids of their own, and it maps into copy j
    mod t of the taxon set, so the table has at least ``min_taxa`` taxa
    where k allows."""
    n0, r0 = len(base.mapq), len(base.read_ids)
    k = max(1, -(-min_lines // n0))
    n_tax0 = len(base.taxon_list)
    t_rep = min(k, max(1, -(-min_taxa // n_tax0)))
    return MappingTable(
        lines=[], contig_of_line=[],
        read_ids=["r"] * (r0 * k),
        taxon_list=[f"{t}.{j}" for j in range(t_rep)
                    for t in base.taxon_list],
        read_of_line=np.concatenate(
            [base.read_of_line + j * r0 for j in range(k)]),
        taxon_of_line=np.concatenate(
            [base.taxon_of_line + (j % t_rep) * n_tax0 for j in range(k)]),
        mapq=np.tile(base.mapq, k),
        inv_locations=np.tile(base.inv_locations, k),
        identity=np.tile(base.identity, k),
        start=np.tile(base.start, k), stop=np.tile(base.stop, k),
        read_len=np.tile(base.read_len, k),
    )


def em_bench_realdist(merged_lines, shards, device):
    """The EM round on the run's own mapping distribution: the merged lines
    through the mappings parser into a ``MappingTable``, tiled by
    :func:`tile_table` to at least 5M lines over at least 1000 taxa, on
    ``device`` against the host round (as :func:`em_bench_synthetic`).
    None without lines."""
    if not merged_lines:
        return None
    taxon_info: dict = {}
    for sh in shards:
        for name, length in zip(sh.contig_names, sh.contig_lengths):
            taxon_info.setdefault(extract_taxon_id(name), {})[name] = int(length)
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "mappings")
        with open(fn, "w") as f:
            f.write("\n".join(merged_lines) + "\n")
        base = load_mapping_table(fn, taxon_info)
    tiled = tile_table(base, EM_REALDIST_LINES, EM_REALDIST_TAXA)
    row = em_bench.table_row(tiled, device, EM_REPS)
    return {"em_iter_ms_realdist": row["round_ms"],
            "em_host_round_ms_realdist": row["host_round_ms"],
            "em_ll_rel_diff_realdist": row["ll_rel_diff"],
            "em_f_max_abs_diff_realdist": row["f_max_abs_diff"],
            "em_lines_realdist": row["lines"],
            "em_taxa_realdist": row["taxa"],
            "em_lines_base": len(base.mapq)}


# ---------------------------------------------------------------------------
# several shards
# ---------------------------------------------------------------------------

def shard_seed(i: int) -> int:
    return LARGE_SEED + SHARD_SEED_STEP * i


def run_multishard_bench(n_shards: int, n_reads: int = N_READS,
                         total_bases: int = LARGE_BASES, device="cuda",
                         cache_dir: str = CACHE_DIR):
    """One read set against ``n_shards`` independent databases (seeds
    ``LARGE_SEED + 7919 i``, contig names prefixed ``s{i}|``), each shard's
    reads drawn from its own genomes: one shard's tables on the card at a
    time (the next shard loads on a loader thread meanwhile; the previous
    tables are freed before the next upload), then the union with mapping
    qualities over every shard's candidates (the reference's
    ``--maxmemory`` shard loop and unifyFiles, mapWrap.h:34-213,
    417-429). Returns (detail, merged lines, the shards' contig metadata,
    reads)."""
    device = require_cuda(device)
    params = bench_params()
    detail: dict = {"mode": "multishard", "n_shards": n_shards}
    per = n_reads // n_shards

    # pass 1: every shard's cache, and its reads
    t0 = time.perf_counter()
    read_sets = []
    for i in range(n_shards):
        prefix = cache_prefix(cache_dir, total_bases, shard_seed(i))
        reads_i = None
        try:
            _stamp_ok(prefix, total_bases, shard_seed(i))
            reads_i = _cached_reads(cache_dir, total_bases, shard_seed(i), per)
        except _UNREADABLE:
            pass
        if reads_i is None:
            shard, reads_i, _ = build_db_large(total_bases, per,
                                               shard_seed(i), cache_dir)
            del shard
            gc.collect()
        read_sets.append(reads_i)
    detail["load_s"] = time.perf_counter() - t0
    reads = [r for rs in read_sets for r in rs]

    def load(i):
        shard, _, _ = build_db_large(total_bases, per, shard_seed(i),
                                     cache_dir)
        shard.contig_names = [f"s{i}|{n}" for n in shard.contig_names]
        return shard

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    all_results, meta = [], []
    swap_s, upload_s, map_s, table_gb = [], [], [], []
    totals: dict = {}
    with ThreadPoolExecutor(1) as loader:
        fut = loader.submit(load, 0)
        for i in range(n_shards):
            t0 = time.perf_counter()
            shard = fut.result()
            if i + 1 < n_shards:
                fut = loader.submit(load, i + 1)
            t_up = time.perf_counter()
            tables = device_tables(shard, device)
            _sync(device)
            upload_s.append(time.perf_counter() - t_up)
            swap_s.append(time.perf_counter() - t0)
            table_gb.append(tables.nbytes() / 1e9)
            engine = make_engine(shard, params, device, tables)
            if i == 0:
                warm_up(engine, reads)
            before = engine_counters(engine)
            _sync(device)
            t0 = time.perf_counter()
            all_results.append(engine.map_reads(reads))
            _sync(device)
            map_s.append(time.perf_counter() - t0)
            counts = counters_since(engine, before)
            detail[f"shard{i}_fallbacks"] = counts["oracle_fallbacks"]
            detail[f"shard{i}_phase_s"] = dict(engine.stats["phase_s"])
            for k, v in counts.items():
                if k == "sweep_launches":
                    acc = totals.setdefault(k, {})
                    for name, n in v.items():
                        acc[name] = acc.get(name, 0) + n
                else:
                    totals[k] = totals.get(k, 0) + v
            meta.append(SimpleNamespace(contig_names=shard.contig_names,
                                        contig_lengths=shard.contig_lengths))
            # the card's tables and the host shard go before the next upload
            del engine, tables, shard
            gc.collect()
            log(f"shard {i}: swap {swap_s[-1]:.1f} s (upload "
                f"{upload_s[-1]:.1f} s), map {map_s[-1]:.3f} s")
    t0 = time.perf_counter()
    merged_lines, n_mapped = unify_lines(params, all_results, meta,
                                         len(reads))
    detail["unify_s"] = time.perf_counter() - t0
    detail.update(
        db_bases=int(sum(sum(m.contig_lengths) for m in meta)),
        swap_s_per_shard=swap_s, upload_s_per_shard=upload_s,
        map_s_per_shard=map_s, device_table_gb_per_shard=table_gb,
        **totals,
        n_reads=len(reads), n_mapped=n_mapped,
        mean_mappings_per_read=len(merged_lines) / max(1, len(reads)),
        map_s=sum(map_s),
        reads_per_s_map=len(reads) / sum(map_s),
        reads_per_s_amortized=len(reads) / (sum(map_s) + sum(swap_s)
                                            + detail["unify_s"]),
        peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
    )
    return detail, merged_lines, meta, reads


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def emit(value, detail: dict) -> None:
    print(json.dumps({"metric": "mapping_throughput", "value": value,
                      "unit": "reads/s/card", "detail": detail}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 x 1 Mbp uniform random genomes, 512 reads")
    ap.add_argument("--bases", type=int, default=LARGE_BASES,
                    help="bases of each structured database")
    ap.add_argument("--shards", type=int, default=1,
                    help="independent databases the reads map against")
    ap.add_argument("--reads", type=int, default=None,
                    help=f"reads (default {N_READS}; {QUICK_READS} with "
                    "--quick)")
    ap.add_argument("--prebuild-shards", type=int, default=0, metavar="N",
                    help="build the caches of N shards and stop")
    ap.add_argument("--dump-mappings", metavar="FILE",
                    help="write the merged mappings and their sidecars")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = require_cuda(args.device)
    n_reads = args.reads or (QUICK_READS if args.quick else N_READS)
    params = bench_params()
    if args.prebuild_shards:
        n = args.prebuild_shards
        for i in range(n):
            build_db_large(args.bases, n_reads if i == 0 else n_reads // n,
                           shard_seed(i))
        log(f"{n} shard caches ready under {CACHE_DIR}")
        return 0

    card = card_name(device)
    rng = np.random.default_rng(7)
    if args.shards > 1 and not args.quick:
        detail, merged_lines, shards, reads = run_multishard_bench(
            args.shards, n_reads, args.bases, device)
        value = detail["reads_per_s_map"]
    else:
        if args.quick:
            t0 = time.perf_counter()
            genomes, shard = build_db_quick(rng)
            detail = {"mode": "quick", "db_build_s": time.perf_counter() - t0}
            reads = make_reads_quick(rng, genomes, n_reads)
            del genomes
        else:
            shard, reads, info = build_db_large(args.bases, n_reads)
            detail = {"mode": "large", **info}
        engine, results = map_shard_bench(shard, reads, params, device,
                                          detail)
        del engine
        shards = [shard]
        value = len(reads) / detail["map_s"]
    detail.update(device=str(device), card=card)
    emit(value, detail)

    row = em_bench_synthetic(rng, device)
    detail.update(em_iter_ms_1Mlines=row["round_ms"],
                  em_host_round_ms_1Mlines=row["host_round_ms"],
                  em_ll_rel_diff_1Mlines=row["ll_rel_diff"],
                  em_f_max_abs_diff_1Mlines=row["f_max_abs_diff"])
    if args.shards <= 1 or args.quick:
        t0 = time.perf_counter()
        merged_lines, _ = unify_lines(params, [results], shards, len(reads))
        detail["unify_s"] = time.perf_counter() - t0
    if args.dump_mappings:
        dump_mappings(args.dump_mappings, merged_lines, reads, params,
                      detail["db_bases"])
        log(f"{len(merged_lines)} mapping lines -> {args.dump_mappings}")
    real = em_bench_realdist(merged_lines, shards, device)
    if real:
        detail.update(real)
    emit(value, detail)
    return 0


if __name__ == "__main__":
    sys.exit(main())
