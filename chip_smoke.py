#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``metamaps_tpu_torch``) on one
NVIDIA card: builds the L2 sweep kernels from ``metamaps_tpu_torch/csrc``,
holds each against its plain PyTorch version, drives the port's main path
-- ``mapDirectly`` followed by ``classify`` (EM rounds on the card) through
the port's CLI -- on a mock-community-scale synthetic database, checks the
outputs, then drives the sweep bench, the path of the other sweep kernels,
and then the lab's day-to-day path on the same data: ``index`` into stored
shards, ``mapAgainstIndex``, ``classify`` and ``classifyU``.

    python3 chip_smoke.py                  # 36 genomes x 3 Mbp, 4096 reads
    python3 chip_smoke.py --reads 512 --genome-len 1000000

Phases (each prints its wall seconds; any failure exits non-zero):

1. environment: torch / CUDA versions and the card; no card, no run;
2. build: one nvcc -c per kernel source, all at once, for sm_90a, linked
   into one library under build/metamaps_tpu_torch/;
3. kernel vs plain on the card, bit for bit: the real L2 event streams of
   the first read chunk through all three sweep kernels (per slab each
   kernel's time, and the candidates and events in each of the two modes),
   random contract-conforming streams with plane widths below and above 48
   KB of shared memory, and paired (setup-shaped) and mixed streams at
   each kernel's widths (batch sp 128, 1280, 10240; row-block sp 128,
   1280, 3584; eager s_pad 1024, 2048, 10240); CUDA-event timings;
4. main path: synthetic DB (write_synth_db_dir) + ONT-like reads, then the
   port's ``mapDirectly`` (torch engine on CUDA) and ``classify`` (EM rounds
   in float64 on CUDA);
5. checks: the sweep kernel ran on the main path, oracle fallbacks <= 1%
   of mappable reads, a 64-read sample gives byte-identical mapping lines
   on the device engine and the serial oracle, .meta counts add up, >= 90%
   of reads mapped; ``classify --emBackend numpy`` on a copy of the
   mappings writes the same bytes in all seven .EM* files, two EM rounds on
   the card give the same bits, and a round's seconds on the card and on
   the host, and the same at 1M and 12M lines (profiling/em_bench.py);
6. breakdown: a fresh engine on the uploaded tables maps the reads once
   more with a synchronise after each phase, and prints each phase's
   seconds;
7. sweep_variants: the sweep bench (profiling/sweep_bench.py) drives the
   row-block, eager and ablation kernels at the JAX engine's slab shapes,
   with random and setup-shaped streams, and the ablation in its modes c,
   cm, cms and cmsf; each is then held bit for bit against its plain
   version on every scenario and in every mode (the ablation's output,
   fold state and planes);
8. map_against_index: ``index`` stores the same database in at least two
   shards (``--maxmemory 1``, or a byte budget where 1 GB does not cut
   it), ``mapAgainstIndex`` (torch engine on CUDA) maps the same reads over
   them; checks: the sweep kernel ran, oracle fallbacks <= 1%, >= 90% of
   reads mapped, .meta adds up, device memory back at its level before the
   run, and a 64-read sample (8 files of 8 reads) gives byte-identical
   mapping and .meta files with ``--mapping-engine oracle`` (8 worker
   processes); then ``classify`` and ``classifyU`` (with a
   selfSimilarities.txt for the genus nodes, made from ``--seed``) on the
   multi-shard output: every .U* file written, every mapped read in
   .U.reads2Taxon;
9. long_read: a ~62 kb read of genome 0 mapped at ``--pi 60 --window 3``
   against that genome: its sketch (~31,000 hashes) is wider than the batch
   kernel's shared-memory planes take (``BATCH_SP_MAX``), and its minimum
   hits (~19) stay within the L1 detector's shift limit, so its slab is
   swept on the card by the wide kernel (planes in device memory, each
   candidate's events split into chunks swept at once); checks: the wide
   kernel ran, no oracle fallback, the read maps where it was drawn, and
   the wide kernel equals its plain version bit for bit on the read's real
   slab and on random and paired streams at widths up to the widest
   bucket's plane, and its own default output at two forced chunk
   lengths; for the record, the batch and wide kernels on one
   setup-shaped candidate of 150,000 events at sp = BATCH_SP_MAX (equal
   outputs, both times);
10. summary: reads/s of both mapping paths, classify seconds, peak device
   memory, then the card line, the kernel JSON line and the final JSON
   line.
"""
from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from metamaps_tpu_torch.cli import _add_sketch_args, _sketch_params
from metamaps_tpu_torch.cli import main as cli_main
from metamaps_tpu_torch.engine import em, mapper_oracle
from metamaps_tpu_torch.engine.index import (
    SketchShard,
    build_shards,
    create_index,
    load_index_manifest,
    reference_memory_model,
)
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.io.fasta import read_sequences
from metamaps_tpu_torch.io.mappings import (MappingLine, parse_mapping_line,
                                            read_meta)
from metamaps_tpu_torch.io.native import winnow_native
from metamaps_tpu_torch.ops import l1, l2_sweep, l2_sweep_parts
from metamaps_tpu_torch.profiling import em_bench, sweep_bench
from metamaps_tpu_torch.profiling.sweep_ab import LONG_READ, LONG_READ_ARGS
from metamaps_tpu_torch.sim.synth_db import ont_read, write_synth_db_dir

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 64  # reads checked line by line against the serial oracle
# paired and mixed streams: each sweep kernel's plane widths, and E2 at each
STREAM_WIDTHS = {"l2_event_sweep_batch": (128, 1280, 10240),
                 "l2_event_sweep_rb": (128, 1280, 3584),
                 "l2_event_sweep": (1024, 2048, 10240)}
STREAM_E2 = {128: 600, 1024: 900, 1280: 1400, 2048: 1200, 3584: 800,
             10240: 400}
EM_FILES = (".EM", ".EM.WIMP", ".EM.reads2Taxon", ".EM.reads2Taxon.krona",
            ".EM.contigCoverage", ".EM.evidenceUnknownSpecies",
            ".EM.lengthAndIdentitiesPerMappingUnit")
U_FILES = (".mapQ_U", ".U.WIMP", ".U.WIMP.absoluteClassifiedAt",
           ".U.reads2Taxon", ".U.lengthAndIdentitiesPerTaxonID",
           ".U.shiftedHistogramsPerTaxonID", ".EM2U.details", ".EM2U.summary")
SAMPLE_PARTS = 8  # files (and oracle worker processes) of the sample
# LONG_READ (62 kb): at w = 3 its planes are wider than BATCH_SP_MAX; at
# LONG_READ_ARGS' --pi 60 the minimum hits of a ~31,000-hash sketch (~19)
# are within the L1 detector's shift limit (32), so the read reaches the
# sweep; at --pi 75 (~250) it would go to the serial oracle in both
# packages' engines
WIDE_STREAM_WIDTHS = (28928, 41088)  # just above BATCH_SP_MAX; widest bucket
WIDE_FORCED_CHUNKS = (256, 2048)  # chunk lengths held against the default
SETUP_EVENTS = 150_000  # one setup-shaped candidate at sp = BATCH_SP_MAX
# --minreads of classify and classifyU: U fits its identity model on a
# contig with more assigned reads than this (the default, 10000, is a real
# sample's); 4096 reads put ~110 on each of the 36 genomes
U_MIN_READS = "50"

# the serial oracle takes seconds per read at this database size, so the
# sample is mapped by a pool of spawned workers that load the shard from disk
_worker_state: dict = {}


def _oracle_worker_init(shard_path: str, params) -> None:
    _worker_state["shard"] = SketchShard.load(shard_path)
    _worker_state["params"] = params


def _oracle_map(seq):
    return mapper_oracle.map_read(_worker_state["shard"],
                                  _worker_state["params"], seq)


def _cli_worker(argv):
    """One port CLI command in a spawned worker process: (exit code,
    engine counters)."""
    engine_stats: dict = {}
    return cli_main(argv, engine_stats=engine_stats), engine_stats


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def write_self_similarities(db: str, rng) -> int:
    """A selfSimilarities.txt for every genus node of the database's
    taxonomy (the shape tests/test_u_pipeline.py writes): per read length,
    identities around a centre drawn from ``rng``. Returns the node count."""
    with open(os.path.join(db, "taxonomy", "nodes.dmp")) as f:
        genera = [row[0] for row in (l.split("\t|\t") for l in f)
                  if row[2].startswith("genus")]
    with open(os.path.join(db, "selfSimilarities.txt"), "w") as f:
        for node in genera:
            centre = int(rng.integers(84, 93))
            for rl in (2000, 5000, 10000, 20000):
                for d, p in ((-4, 0.1), (-2, 0.2), (0, 0.4), (2, 0.2),
                             (4, 0.1)):
                    f.write(f"{node}\t{rl}\t{centre + d}\t{p}\t\n")
    return len(genera)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Phase:
    """Context manager that prints a phase's wall seconds."""

    def __init__(self, name: str, times: dict):
        self.name, self.times = name, times

    def __enter__(self):
        log(f"phase {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.times[self.name] = dt
        log(f"phase {self.name}: {dt:.2f} s{' (failed)' if exc[0] else ''}")
        return False


def compare(label, fn, ref, arrs, *width, timed: dict = None, locate=None):
    """A kernel wrapper ``fn`` against its plain version ``ref`` on the same
    CUDA tensors; returns the max abs difference. Exact int32 arithmetic:
    any difference fails. ``timed``, when given, gets the plain call's
    milliseconds by CUDA events (``plain_ms``); ``locate(got, want)``, when
    given, says where a difference comes from before the failure."""
    got = fn(*arrs, *width)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = ref(*arrs, *width)
    end.record()
    torch.cuda.synchronize()
    if timed is not None:
        timed["plain_ms"] = start.elapsed_time(end)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    n, e2 = arrs[1].shape
    log(f"{fn.__name__} vs plain, {label}: N={n} E2={e2} "
        f"width={list(width)} max_abs_err={err}")
    if err != 0 or not torch.equal(got, want):
        if locate is not None:
            log(f"{fn.__name__} on {label}: {locate(got, want)}")
        raise AssertionError(f"{fn.__name__} differs from plain on {label}")
    return err


def kernel_entry(name, source, replaces, arrs, width, clock_mhz, err, fn,
                 ref, sp=None, bound=None, plain_ms=None, **extra):
    """One row of the kernels line: the kernel's and the plain version's
    CUDA-event times on ``arrs`` (``plain_ms`` where the caller timed it
    already) and the bound on the same inputs, from the work this data
    needs: ``bound`` (ms, bound_by, counts) where given, else
    ``sweep_bench.sweep_bound`` with ``sp``, and then the row also carries
    the bound with every event recounted and the events in each mode."""
    ms = sweep_bench.time_ms(lambda: fn(*arrs, *width), arrs[0].device, 5)
    if plain_ms is None:
        plain_ms = sweep_bench.time_ms(lambda: ref(*arrs, *width),
                                       arrs[0].device, 1)
    if bound is None:
        host = [a.cpu().numpy() for a in arrs]
        bound = sweep_bench.sweep_bound(host[0], host[1], host[2], clock_mhz,
                                        sp=sp)
        extra.update(recount_bound_ms=bound[2]["recount_ms"],
                     incremental_events=bound[2]["incremental_events"],
                     recount_events=bound[2]["recount_events"])
    bound_ms, bound_by, counts = bound
    log(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {counts})")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=[int(arrs[1].shape[0]), int(arrs[1].shape[1]),
                       width[0]], **extra)


def write_fastq(path, reads, first: int = 0):
    with open(path, "w") as f:
        for i, seq in enumerate(reads, first):
            s = seq.tobytes().decode()
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def sketch_params(argv):
    """The Parameters the port's CLI derives from sketch arguments."""
    p = argparse.ArgumentParser()
    _add_sketch_args(p)
    return _sketch_params(p.parse_known_args(argv)[0])


def prepare_long_read(rng, db_fa: str, lr_dir: str) -> dict:
    """Draw a ~62 kb read of the database's first genome and write it, and
    that genome as its reference, under ``lr_dir``."""
    os.makedirs(lr_dir, exist_ok=True)
    name0, g0 = next(read_sequences(db_fa))
    ref = os.path.join(lr_dir, "ref.fa")
    with open(ref, "w") as f:
        f.write(f">{name0}\n{g0.tobytes().decode()}\n")
    pos = int(rng.integers(0, len(g0) - LONG_READ))
    read = ont_read(rng, g0[pos:pos + LONG_READ + 1], LONG_READ)
    fq = os.path.join(lr_dir, "read.fastq")
    write_fastq(fq, [read])
    return dict(dir=lr_dir, ref=ref, fq=fq, read=read, pos=pos, contig=name0)


def map_against_index(args, times: dict, db: str, fq: str, reads, shard,
                      card: str, counters, dev) -> dict:
    """Store the database in at least two shards, map ``fq`` over them with
    ``mapAgainstIndex`` (torch engine), check the run and a sample against
    the serial oracle, then run ``classify`` and ``classifyU`` on its
    output. Returns the numbers of the run."""
    db_fa = os.path.join(db, "DB.fa")
    idx = os.path.join(args.workdir, "index", "DB")
    out_mai = os.path.join(args.workdir, "mai", "out")
    with Phase("index_stored", times):
        os.makedirs(os.path.dirname(idx), exist_ok=True)
        os.makedirs(os.path.dirname(out_mai), exist_ok=True)
        # the reference memory model of the whole database as one shard
        hashes = 1 + int(np.count_nonzero(np.diff(shard.hash_sorted)))
        model_bytes = reference_memory_model(hashes, shard.n_minimizers)
        if model_bytes > 2**30:
            budget = "--maxmemory 1"
            if cli_main(["index", "--reference", db_fa, "--index", idx,
                         "--maxmemory", "1"]) != 0:
                raise AssertionError("index failed")
        else:  # 1 GB holds it: cut it with a byte budget
            budget = model_bytes // 2 + 1
            p_idx = sketch_params(["--reference", db_fa])
            p_idx.index = idx
            create_index(p_idx, idx, budget)
        shard_files = load_index_manifest(idx)
        log(f"memory model of the database as one shard: {model_bytes} B "
            f"({hashes} hashes, {shard.n_minimizers} minimizers); budget "
            f"{budget}: {len(shard_files)} stored shards ({card})")
        if len(shard_files) < 2:
            raise AssertionError(f"{len(shard_files)} stored shard(s), "
                                 "expected at least 2")

    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    mai_stats: dict = {}
    with Phase("map_against_index", times):
        if cli_main(["mapAgainstIndex", "--index", idx, "--query", fq,
                     "--output", out_mai, "--all", "--mapping-engine",
                     "torch"], engine_stats=mai_stats) != 0:
            raise AssertionError("mapAgainstIndex failed")
        torch.cuda.synchronize()
    mai_launches = l2_sweep.l2_event_sweep_batch.launches
    gc.collect()
    mem_after = torch.cuda.memory_allocated(dev)

    with Phase("map_against_index_checks", times):
        mai_meta = read_meta(out_mai)
        mai_mappable = mai_meta["TotalReads"] - mai_meta["ReadsTooShort"]
        mai = dict(
            card=card, shards=len(mai_stats["shard_load_s"]),
            shard_load_s=mai_stats["shard_load_s"],
            index_build_s=times["index_stored"], model_bytes=model_bytes,
            budget=budget, map_against_index_s=times["map_against_index"],
            mapping_s=mai_stats["map_s"], minhits_s=mai_stats["minhits_s"],
            mapping_reads_per_s=mai_mappable / mai_stats["map_s"],
            oracle_fallbacks=mai_stats["oracle_fallbacks"],
            reads_mappable_over_shards=mai_stats["reads_mappable"],
            l2_candidates=mai_stats["l2_candidates"],
            sweep_launches=mai_launches, device_bytes_before=mem_before,
            device_bytes_after=mem_after, meta=mai_meta)
        log("mapAgainstIndex " + json.dumps(mai))
        if mai_launches <= 0:
            raise AssertionError("the sweep kernel never ran in "
                                 "mapAgainstIndex")
        if mai["oracle_fallbacks"] > 0.01 * mai["reads_mappable_over_shards"]:
            raise AssertionError(f"{mai['oracle_fallbacks']} oracle "
                                 "fallbacks in mapAgainstIndex")
        if mai_meta["TotalReads"] != (mai_meta["ReadsTooShort"]
                                      + mai_meta["ReadsMapped"]
                                      + mai_meta["ReadsNotMapped"]):
            raise AssertionError("mapAgainstIndex .meta does not add up")
        if mai_meta["TotalReads"] != len(reads):
            raise AssertionError("mapAgainstIndex .meta TotalReads differs")
        if mai_meta["ReadsMapped"] < 0.9 * len(reads):
            raise AssertionError(f"mapAgainstIndex mapped only "
                                 f"{mai_meta['ReadsMapped']} reads")
        if mem_after != mem_before:
            raise AssertionError(f"device memory {mem_after} B after "
                                 f"mapAgainstIndex, {mem_before} B before")
        # the sample in SAMPLE_PARTS files: the torch engine maps them in one
        # call, the serial oracle in one worker process each
        sdir = os.path.join(args.workdir, "sample")
        os.makedirs(sdir, exist_ok=True)
        per = SAMPLE // SAMPLE_PARTS
        parts = [os.path.join(sdir, f"part{i}.fastq")
                 for i in range(SAMPLE_PARTS)]
        for i, path in enumerate(parts):
            write_fastq(path, reads[i * per:(i + 1) * per], first=i * per)
        outs = {e: [os.path.join(sdir, f"{e}{i}") for i in range(SAMPLE_PARTS)]
                for e in ("torch", "oracle")}
        if cli_main(["mapAgainstIndex", "--index", idx, "--query",
                     ",".join(parts), "--output", ",".join(outs["torch"]),
                     "--all", "--mapping-engine", "torch"]) != 0:
            raise AssertionError("mapAgainstIndex on the sample failed")
        with multiprocessing.get_context("spawn").Pool(SAMPLE_PARTS) as pool:
            _POOLS.append(pool)
            rcs = pool.map(_cli_worker, [
                ["mapAgainstIndex", "--index", idx, "--query", q, "--output",
                 o, "--all", "--mapping-engine", "oracle"]
                for q, o in zip(parts, outs["oracle"])])
        if any(rc != 0 for rc, _ in rcs):
            raise AssertionError("mapAgainstIndex --mapping-engine oracle "
                                 "failed")
        n_lines = 0
        for t_out, o_out in zip(outs["torch"], outs["oracle"]):
            for suffix in ("", ".meta"):
                if not same_bytes(t_out + suffix, o_out + suffix):
                    raise AssertionError(f"{t_out}{suffix}: torch engine "
                                         "and oracle differ")
            with open(o_out) as f:
                n_lines += sum(1 for _ in f)
        mai["sample_lines"] = n_lines
        log(f"{SAMPLE}-read sample over {len(shard_files)} stored shards: "
            f"{n_lines} mapping lines and .meta byte-identical with the "
            f"torch engine and the serial oracle ({SAMPLE_PARTS} files)")

    with Phase("classify_U", times):
        n_genera = write_self_similarities(
            db, np.random.default_rng(args.seed + 1))
        t0 = time.perf_counter()
        if cli_main(["classify", "--DB", db, "--mappings", out_mai,
                     "--minreads", U_MIN_READS]) != 0:
            raise AssertionError("classify on the mapAgainstIndex output "
                                 "failed")
        mai["classify_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if cli_main(["classifyU", "--DB", db, "--mappings", out_mai,
                     "--minreads", U_MIN_READS]) != 0:
            raise AssertionError("classifyU failed")
        mai["classifyU_s"] = time.perf_counter() - t0
        for suffix in U_FILES:
            if not os.path.getsize(out_mai + suffix):
                raise AssertionError(f"{suffix} is empty")
        with open(out_mai) as f:
            mapped_ids = {line.split(" ", 1)[0] for line in f}
        with open(out_mai + ".U.reads2Taxon") as f:
            u_ids = {line.split("\t", 1)[0] for line in f}
        if mapped_ids - u_ids:
            raise AssertionError(f"{len(mapped_ids - u_ids)} mapped reads "
                                 "missing from .U.reads2Taxon")
        log(f"classifyU: {len(U_FILES)} .U* files written, {len(mapped_ids)} "
            f"mapped reads all in .U.reads2Taxon; selfSimilarities for "
            f"{n_genera} genus nodes; classify {mai['classify_s']:.2f} s, "
            f"classifyU {mai['classifyU_s']:.2f} s ({card})")
    return mai


def long_read(run: dict, times: dict, card: str, counters, dev,
              clock_mhz: float) -> tuple:
    """Map the long read with ``mapDirectly`` (torch engine on CUDA): its
    slab goes to the wide sweep kernel. Then hold that kernel against its
    plain version on the read's real slab and on synthetic streams. Returns
    (the run's numbers, the kernels line's row of the wide kernel)."""
    wide = l2_sweep.l2_event_sweep_wide
    ref = l2_sweep.l2_event_sweep_ref
    out = os.path.join(run["dir"], "out")
    argv = ["mapDirectly", "--reference", run["ref"], "--query", run["fq"],
            "--output", out, "--all", "--mapping-engine", "torch",
            *LONG_READ_ARGS]
    params = sketch_params(argv[1:])
    k, w = params.kmer_size, params.window_size
    sketch_size = mapper_oracle.sketch_read(run["read"], k, w)[0].size
    minhits = int(l1.minhits_table(sketch_size, k,
                                   params.percentage_identity)[sketch_size])
    log(f"long read: {len(run['read'])} bp of {run['contig']} at "
        f"{run['pos']}; {' '.join(LONG_READ_ARGS)}: sketch {sketch_size} "
        f"hashes (planes of {sketch_size + 1} ranks; the batch kernel's "
        f"shared memory takes {l2_sweep.BATCH_SP_MAX}), minimum hits "
        f"{minhits}")
    if sketch_size < l2_sweep.BATCH_SP_MAX:
        raise AssertionError("the long read's planes fit shared memory")
    if minhits - 1 >= l1.MINHITS_SHIFT_MAX:
        raise AssertionError("the long read would go to the oracle")
    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    stats: dict = {}
    with Phase("long_read", times):
        if cli_main(argv, engine_stats=stats) != 0:
            raise AssertionError("mapDirectly on the long read failed")
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    with Phase("long_read_checks", times):
        with open(out) as f:
            lines = [parse_mapping_line(line) for line in f]
        info = dict(bp=len(run["read"]), drawn_at=run["pos"],
                    sketch=sketch_size, minhits=minhits, w=w,
                    lines=len(lines), launches=launches,
                    oracle_fallbacks=stats["oracle_fallbacks"],
                    map_s=stats["map_s"], minhits_s=stats["minhits_s"],
                    mapDirectly_s=times["long_read"], card=card)
        if launches[wide.__name__] <= 0:
            raise AssertionError("the wide sweep kernel never ran on the "
                                 "long read")
        if stats["oracle_fallbacks"] != 0 or stats["reads_mappable"] != 1:
            raise AssertionError("the long read went to the oracle")
        best = max(lines, key=lambda m: m.intersection)
        info.update(ref_start=best.ref_start, identity=best.identity,
                    intersection=best.intersection)
        log("long read " + json.dumps(info))
        if (best.contig_id != run["contig"]
                or abs(best.ref_start - run["pos"]) > LONG_READ // 20):
            raise AssertionError(f"the long read mapped to {best.contig_id}:"
                                 f"{best.ref_start}, drawn at {run['pos']}")
        shards = []
        build_shards(params, 0, lambda sh, n: shards.append(sh))
        engine = TorchMapperEngine(shards[0], params, device=dev)
        slabs = engine.l2_slab_setups([run["read"]])
        errs = []
        timed: dict = {}  # the plain version takes ~90 s on this slab: once
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for i, (st, sp) in enumerate(slabs):
            arrs = [t.contiguous() for t in (st.meta, st.qrank, st.signinq,
                                             st.rows)]
            if sp <= l2_sweep.BATCH_SP_MAX:
                raise AssertionError(f"long-read slab {i}: sp {sp}")
            plan = l2_sweep.wide_plan(*arrs[1].shape, sp, sms)

            def locate(got, want, arrs=arrs, sp=sp, L=plan[0]):
                """Whether the split itself or its kernel differs."""
                split = l2_sweep.l2_event_sweep_split_ref(*arrs, sp, L)
                verb = lambda a, b: "equals" if torch.equal(a, b) else \
                    "differs from"
                return (f"the split's plain model at L={L} "
                        f"{verb(split, want)} the plain version, the kernel "
                        f"{verb(got, split)} the model")

            errs.append(compare(f"long-read slab {i} (L, P, W, G = {plan})",
                                wide, ref, arrs, sp, locate=locate,
                                timed=timed if i == 0 else None))
            if i == 0:
                slab0 = (arrs, sp, plan)
        # the same slab at other chunk lengths, kernel against kernel
        arrs, sp, plan = slab0
        default_out = wide(*arrs, sp)
        chunk_ms = {}
        for L in WIDE_FORCED_CHUNKS:
            if not torch.equal(wide(*arrs, sp, chunk_events=L), default_out):
                raise AssertionError(f"the wide kernel at L={L} differs from "
                                     f"its default L={plan[0]} on the long "
                                     "read's slab")
            chunk_ms[L] = sweep_bench.time_ms(
                lambda: wide(*arrs, sp, chunk_events=L), dev, 5)
        log(f"long-read slab 0 at forced chunk lengths, ms: {chunk_ms}; "
            f"outputs equal to the default L={plan[0]}'s")
        # for the record: one setup-shaped candidate at the widest plane the
        # batch kernel takes, through both kernels
        sp_b = l2_sweep.BATCH_SP_MAX
        host = l2_sweep.long_event_stream(np.random.default_rng(sp_b),
                                          SETUP_EVENTS, sp_b - 1)
        arrs_b = [torch.from_numpy(a).to(dev) for a in host]
        batch = l2_sweep.l2_event_sweep_batch
        if not torch.equal(batch(*arrs_b, sp_b), wide(*arrs_b, sp_b)):
            raise AssertionError(f"the batch and wide kernels differ on a "
                                 f"setup-shaped 1 x {SETUP_EVENTS} stream")
        at_batch_sp = dict(
            events=SETUP_EVENTS, sp=sp_b,
            plan=l2_sweep.wide_plan(1, SETUP_EVENTS, sp_b, sms),
            batch_ms=sweep_bench.time_ms(lambda: batch(*arrs_b, sp_b), dev, 3),
            wide_ms=sweep_bench.time_ms(lambda: wide(*arrs_b, sp_b), dev, 3))
        log("setup-shaped candidate at sp = BATCH_SP_MAX, batch and wide "
            f"kernels equal: {json.dumps(at_batch_sp)}")
        for sp_r in WIDE_STREAM_WIDTHS:
            for kind, flip in (("random", None), ("paired", 0.0),
                               ("mixed", 0.04)):
                rng = np.random.default_rng(sp_r)
                host = (l2_sweep.random_event_streams(rng, 37, 300, sp_r - 1)
                        if flip is None else l2_sweep.paired_event_streams(
                            rng, 37, 300, sp_r - 1, flip=flip))
                errs.append(compare(
                    f"{kind} sp={sp_r}", wide, ref,
                    [torch.from_numpy(a).to(dev) for a in host], sp_r))
        row = kernel_entry(
            wide.__name__, "metamaps_tpu_torch/csrc/l2_sweep_wide.cu",
            "metamaps_tpu/ops/l2_pallas.py:116", arrs, (sp,), clock_mhz,
            max(errs), wide, ref, sp=sp, plain_ms=timed["plain_ms"],
            scenario="long-read slab 0", plain_calls=1,
            sources=["metamaps_tpu_torch/csrc/l2_sweep_wide.cu",
                     "metamaps_tpu_torch/csrc/l2_sweep_common.cuh"],
            plan=dict(zip(("L", "P", "W", "G"), plan)),
            workspace_bytes=plan[3] * plan[2] * 8 * sp,
            ms_by_chunk=chunk_ms, at_batch_sp=at_batch_sp)
        row["launches"] = launches[wide.__name__]
        del engine, shards
    return info, row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genera", type=int, default=12)
    ap.add_argument("--species", type=int, default=3)
    ap.add_argument("--genome-len", type=int, default=3_000_000)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "chip_smoke"))
    args = ap.parse_args(argv)
    times: dict = {}
    counters = (l2_sweep.l2_event_sweep_batch, l2_sweep.l2_event_sweep_rb,
                l2_sweep.l2_event_sweep, l2_sweep_parts.l2_sweep_parts,
                l2_sweep.l2_event_sweep_wide)

    # ---- 1. environment --------------------------------------------------
    with Phase("environment", times):
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this "
                               "smoke test runs on an NVIDIA card only")

        def smi(query):
            return subprocess.run(
                ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60,
            ).stdout.strip().splitlines()[0]

        card = smi("name,power.limit")
        clock_mhz = float(smi("clocks.max.sm").split()[0])
        log(f"card: {card}; max SM clock {clock_mhz} MHz; torch sees "
            f"{torch.cuda.device_count()} device(s): "
            f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build ---------------------------------------------------------
    with Phase("build", times):
        l2_sweep.load_library()
        info = l2_sweep.build_info
        log(f"kernel library {info['library']} built in "
            f"{info.get('seconds', 0.0):.2f} s")
        for line in info.get("report", "").splitlines():
            log(f"  {line}")

    # ---- 4a. database, reads, index (inputs of phases 3 and 4) -----------
    os.makedirs(args.workdir, exist_ok=True)
    db = os.path.join(args.workdir, "DB")
    fq = os.path.join(args.workdir, "reads.fastq")
    out = os.path.join(args.workdir, "out")
    with Phase("data", times):
        rng = np.random.default_rng(args.seed)
        if os.path.exists(db):
            shutil.rmtree(db)
        write_synth_db_dir(db, rng, n_genera=args.genera,
                           species_per_genus=args.species,
                           genome_len=args.genome_len)
        genomes = [seq for _, seq in read_sequences(os.path.join(db, "DB.fa"))]
        # the JAX bench's read mix (bench.py:385, make_ont_reads)
        reads = []
        for _ in range(args.reads):
            g = genomes[int(rng.integers(0, len(genomes)))]
            length = int(rng.integers(3000, 7600))
            reads.append(ont_read(rng, g, length)[:8192])
        write_fastq(fq, reads)
        log(f"DB {len(genomes)} genomes, {sum(map(len, genomes))} bp; "
            f"{len(reads)} reads, {sum(map(len, reads))} bp")
    db_fa = os.path.join(db, "DB.fa")

    # ---- 9a. the long read, drawn now (it runs in phase 9) ---------------
    long_run = prepare_long_read(rng, db_fa,
                                 os.path.join(args.workdir, "long_read"))

    argv_map = ["mapDirectly", "--reference", db_fa,
                "--query", fq, "--output", out, "--all",
                "--mapping-engine", "torch"]
    with Phase("index", times):
        params = sketch_params(argv_map[1:])
        shards = []
        n_shards = build_shards(params, 0, lambda s, n: shards.append(s))
        if n_shards != 1:
            raise AssertionError(f"expected one shard, got {n_shards}")
        shard = shards[0]
        engine = TorchMapperEngine(shard, params, device=dev)
        native = winnow_native(np.full(64, ord("A"), np.uint8), 16, 8)
        log(f"k={params.kmer_size} w={params.window_size}; "
            f"{shard.n_minimizers} minimizers; device tables "
            f"{engine.tables.nbytes() / 2**20:.1f} MiB; host winnower "
            f"{'native C++' if native is not None else 'numpy'}")

    # ---- 3. kernel vs plain ----------------------------------------------
    with Phase("kernel_vs_plain", times):
        # the main path's first chunk: the first CHUNK reads of read 0's
        # length bucket
        b0 = engine._bucket_of(len(reads[0]))
        chunk = [r for r in reads if engine._bucket_of(len(r)) == b0]
        setups = engine.l2_slab_setups(chunk[: engine.CHUNK])
        ref = l2_sweep.l2_event_sweep_ref
        batch = l2_sweep.l2_event_sweep_batch
        # the three sweep kernels of one function, each with its plane
        # width at a candidate set's sp
        sweeps = ((batch, lambda sp: sp),
                  (l2_sweep.l2_event_sweep_rb, lambda sp: sp),
                  (l2_sweep.l2_event_sweep, lambda sp: -(-sp // 1024) * 1024))
        errs = {fn.__name__: [] for fn, _ in sweeps}
        slab_ms = {fn.__name__: [] for fn, _ in sweeps}
        slab_modes = []
        for i, (st, sp) in enumerate(setups):
            arrs = [t.contiguous() for t in (st.meta, st.qrank, st.signinq,
                                             st.rows)]
            for fn, width in sweeps:
                errs[fn.__name__].append(compare(
                    f"main-path slab {i}", fn, ref, arrs, width(sp)))
                slab_ms[fn.__name__].append(sweep_bench.time_ms(
                    lambda: fn(*arrs, width(sp)), dev, 5))
            inc, rec = sweep_bench.sweep_routes(
                *(a.cpu().numpy() for a in arrs[:3]), sp)
            modes = dict(candidates=len(inc),
                         incremental_only=int((rec == 0).sum()),
                         with_recount=int((rec > 0).sum()),
                         incremental_events=int(inc.sum()),
                         recount_events=int(rec.sum()))
            slab_modes.append(modes)
            log(f"main-path slab {i}: N={len(inc)} E2={arrs[1].shape[1]} "
                f"sp={sp}; ms " + json.dumps(
                    {k: v[-1] for k, v in slab_ms.items()})
                + "; modes " + json.dumps(modes))
            if i == 0:
                slab0 = (arrs, sp)
        log(f"sweep kernels over the {len(setups)} main-path slabs, ms: "
            + json.dumps({k: sum(v) for k, v in slab_ms.items()})
            + f"; candidates with recount events "
            f"{sum(m['with_recount'] for m in slab_modes)} of "
            f"{sum(m['candidates'] for m in slab_modes)}")
        for sp_r, e2 in ((1152, 900), (10240, 400)):  # 9 KB and 80 KB planes
            arrs = [torch.from_numpy(a).to(dev) for a in
                    l2_sweep.random_event_streams(
                        np.random.default_rng(sp_r), 257, e2, sp_r - 1)]
            errs[batch.__name__].append(
                compare(f"random sp={sp_r}", batch, ref, arrs, sp_r))
        # setup-shaped streams (incremental mode only) and mixed ones, in
        # which ranks go negative and recover, at each kernel's widths
        for fn, _ in sweeps:
            for flip, kind in ((0.0, "paired"), (0.04, "mixed")):
                for sp_r in STREAM_WIDTHS[fn.__name__]:
                    host = l2_sweep.paired_event_streams(
                        np.random.default_rng(sp_r + 1), 257,
                        STREAM_E2[sp_r], sp_r - 1, flip=flip)
                    inc, rec = sweep_bench.sweep_routes(*host[:3], sp_r)
                    arrs = [torch.from_numpy(a).to(dev) for a in host]
                    errs[fn.__name__].append(compare(
                        f"{kind} width={sp_r} (events incremental "
                        f"{int(inc.sum())}, recount {int(rec.sum())})", fn,
                        ref, arrs, sp_r))
        arrs, sp = slab0
        batch_row = kernel_entry(
            "l2_event_sweep_batch", "metamaps_tpu_torch/csrc/l2_sweep.cu",
            "metamaps_tpu/ops/l2_pallas.py:116", arrs, (sp,), clock_mhz,
            max(errs[batch.__name__]), batch, ref, sp=sp,
            ms_by_slab=slab_ms[batch.__name__],
            ms_all_slabs=sum(slab_ms[batch.__name__]),
            modes_by_slab=slab_modes)

    # ---- 4. main path -----------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    engine_stats: dict = {}
    with Phase("mapDirectly", times):
        if cli_main(argv_map, engine_stats=engine_stats) != 0:
            raise AssertionError("mapDirectly failed")
        torch.cuda.synchronize()
    with Phase("classify", times):
        if cli_main(["classify", "--DB", db, "--mappings", out]) != 0:
            raise AssertionError("classify failed")
    launches = l2_sweep.l2_event_sweep_batch.launches
    peak = torch.cuda.max_memory_allocated(dev)

    # ---- 5. checks --------------------------------------------------------
    with Phase("checks", times):
        log(f"engine: {engine_stats}")
        if launches <= 0:
            raise AssertionError("the sweep kernel never ran on the main path")
        mappable = engine_stats["reads_mappable"]
        fallbacks = engine_stats["oracle_fallbacks"]
        if fallbacks > 0.01 * mappable:
            raise AssertionError(f"{fallbacks} oracle fallbacks of {mappable}")
        meta = read_meta(out)
        log(f"meta: {meta}")
        if meta["TotalReads"] != (meta["ReadsTooShort"] + meta["ReadsMapped"]
                                  + meta["ReadsNotMapped"]):
            raise AssertionError(".meta counts do not add up")
        if meta["TotalReads"] != len(reads):
            raise AssertionError(".meta TotalReads differs from the input")
        if meta["ReadsMapped"] < 0.9 * len(reads):
            raise AssertionError(f"only {meta['ReadsMapped']} reads mapped")
        sample = reads[:SAMPLE]
        dev_maps = engine.map_reads(sample)
        shard_path = os.path.join(args.workdir, "shard.npz")
        shard.save(shard_path)
        workers = min(8, os.cpu_count() or 1)
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_oracle_worker_init,
                initargs=(shard_path, params)) as pool:
            oracle_maps = list(pool.map(_oracle_map, sample))

        def lines(maps):
            return [MappingLine(
                read_id=f"read{i}", read_len=m.query_len, strand=m.strand,
                contig_id=shard.contig_names[m.ref_seqid],
                contig_len=shard.contig_lengths[m.ref_seqid],
                ref_start=m.ref_start, ref_end=m.ref_end,
                identity=m.nuc_identity, intersection=m.conserved,
                sketch_size=m.sketch_size).format() for m in maps]

        n_lines = 0
        for i in range(len(sample)):
            want = lines(oracle_maps[i])
            got = lines(dev_maps[i])
            if got != want:
                raise AssertionError(f"read{i}: device {got} != oracle {want}")
            n_lines += len(want)
        log(f"{SAMPLE}-read sample: {n_lines} mapping lines identical on "
            f"the device engine and the serial oracle ({workers} workers)")

    # ---- the EM on the card against the host EM ----------------------------
    with Phase("em_checks", times):
        host = os.path.join(args.workdir, "host")
        os.makedirs(host, exist_ok=True)
        for name in os.listdir(args.workdir):
            if name.startswith("out.meta") or name == "out":
                shutil.copy(os.path.join(args.workdir, name), host)
        host_out = os.path.join(host, "out")
        t0 = time.perf_counter()
        if cli_main(["classify", "--DB", db, "--mappings", host_out,
                     "--emBackend", "numpy"]) != 0:
            raise AssertionError("classify --emBackend numpy failed")
        classify_host_s = time.perf_counter() - t0
        for suffix in EM_FILES:
            with open(out + suffix, "rb") as a, open(host_out + suffix, "rb") as b:
                card_bytes, host_bytes = a.read(), b.read()
            if not card_bytes or card_bytes != host_bytes:
                raise AssertionError(f"{suffix}: EM on the card and on the "
                                     "host wrote different bytes")
        table = em.load_mapping_table(
            out, em.load_relevant_taxon_info(db, set()))
        step = em.make_em_iterate_torch(table, dev)
        f0 = np.full(len(table.taxon_list), 1.0 / len(table.taxon_list))
        (fa, lla), (fb, llb) = step(f0), step(f0)
        if fa.tobytes() != fb.tobytes() or lla != llb:
            raise AssertionError("two EM rounds on the card differ in bits")
        fh, llh = em.em_iterate(table, f0)
        t0 = time.perf_counter()
        for _ in range(5):
            step(f0)
        round_card_ms = (time.perf_counter() - t0) * 200
        t0 = time.perf_counter()
        for _ in range(5):
            em.em_iterate(table, f0)
        round_host_ms = (time.perf_counter() - t0) * 200
        em_stats = dict(
            lines=len(table.lines), reads=len(table.read_ids),
            taxa=len(table.taxon_list), round_card_ms=round_card_ms,
            round_host_ms=round_host_ms, classify_host_s=classify_host_s,
            ll_rel_diff=abs(lla - llh) / abs(llh),
            f_max_abs_diff=float(np.abs(fa - fh).max()),
            # the round at the JAX bench's table sizes (1M and 12M lines)
            scale=em_bench.run(dev, reps=3, log=lambda m: log(f"em_bench {m}")))
        log("EM: 7 .EM* files identical on the card and the host; two "
            "rounds on the card identical in bits; " + json.dumps(em_stats))

    # ---- where the mapping time goes: a fresh engine on the uploaded
    # tables, as mapDirectly builds one, with a synchronise after each phase
    with Phase("breakdown", times):
        fresh = TorchMapperEngine(shard, params, device=dev,
                                  tables=engine.tables, profile=True)
        t0 = time.perf_counter()
        fresh.map_reads(reads)
        breakdown = dict(fresh.stats["phase_s"],
                         total=time.perf_counter() - t0)
        log("mapping phases (s, synchronised): " + json.dumps(breakdown))
    del engine, fresh

    # ---- 7. the sweep bench: the path of the other sweep kernels ----------
    for fn in counters:
        fn.launches = 0
    with Phase("sweep_variants", times):
        bench = sweep_bench.run(dev, reps=10, log=lambda m: log(f"bench {m}"),
                                clock_mhz=clock_mhz)
        bench_launches = {fn.__name__: fn.launches for fn in counters}
        log(f"sweep bench launches: {bench_launches}")
        for fn in counters[1:4]:  # rb, eager, the ablation
            if fn.launches <= 0:
                raise AssertionError(f"{fn.__name__} never ran in the bench")
        by_name = {row["scenario"]: row for row in bench["scenarios"]}
        full = by_name["full"]
        sp = full["sp"]
        for row in bench["scenarios"]:  # every scenario, both kernels
            for fn, width in ((l2_sweep.l2_event_sweep_rb, row["sp"]),
                              (l2_sweep.l2_event_sweep, row["s_pad"])):
                errs[fn.__name__].append(compare(
                    f"bench {row['scenario']}", fn, ref, row["inputs"],
                    width))
        paired_ms = {
            fn: {row["scenario"]: row["ms"][key] for row in bench["scenarios"]
                 if row["scenario"].startswith("paired")}
            for fn, key in (("l2_event_sweep_rb", "rb"),
                            ("l2_event_sweep", "eager"))}
        variant_rows = [
            kernel_entry("l2_event_sweep_rb",
                         "metamaps_tpu_torch/csrc/l2_sweep_rb.cu",
                         "metamaps_tpu/ops/l2_pallas.py:233", full["inputs"],
                         (sp,), clock_mhz, max(errs["l2_event_sweep_rb"]),
                         l2_sweep.l2_event_sweep_rb, ref, sp=sp,
                         scenario="full",
                         ms_by_slab=slab_ms["l2_event_sweep_rb"],
                         paired_ms=paired_ms["l2_event_sweep_rb"]),
            kernel_entry("l2_event_sweep",
                         "metamaps_tpu_torch/csrc/l2_sweep_eager.cu",
                         "metamaps_tpu/ops/l2_pallas.py:41", full["inputs"],
                         (full["s_pad"],), clock_mhz,
                         max(errs["l2_event_sweep"]), l2_sweep.l2_event_sweep,
                         ref, sp=full["s_pad"], scenario="full",
                         ms_by_slab=slab_ms["l2_event_sweep"],
                         paired_ms=paired_ms["l2_event_sweep"]),
        ]
        parts_fn = l2_sweep_parts.l2_sweep_parts
        parts_ref = l2_sweep_parts.l2_sweep_parts_ref
        parts_err = 0
        for row in bench["parts"]:  # every mode the bench times
            arrs, mode, sp_p = row["inputs"], row["mode"], row["sp"]
            got = parts_fn(*arrs, sp_p, mode)
            want = parts_ref(*arrs, sp_p, mode)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want, strict=True))
            log(f"l2_sweep_parts vs plain, mode {mode}: max_abs_err={err} "
                "(output, fold state and planes)")
            if err or not all(map(torch.equal, got, want)):
                raise AssertionError(f"l2_sweep_parts differs from plain "
                                     f"in mode {mode}")
            parts_err = max(parts_err, err)
        variant_rows.append(kernel_entry(
            "l2_sweep_parts", "metamaps_tpu_torch/csrc/l2_sweep_parts.cu",
            "profiling/pallas_sweep_parts.py:30", arrs, (sp_p, "cmsf"),
            clock_mhz, parts_err, parts_fn, parts_ref,
            bound=sweep_bench.parts_bound([a.cpu().numpy() for a in arrs],
                                          sp_p, "cmsf", clock_mhz),
            mode="cmsf",
            config=l2_sweep_parts.parts_config(arrs[1].shape[0], sp_p),
            ms_by_mode={r["mode"]: r["ms"] for r in bench["parts"]},
            bound_ms_by_mode={r["mode"]: r["bound_ms"]
                              for r in bench["parts"]}))
        for row in variant_rows:
            row["launches"] = bench_launches[row["name"]]
        scenario_ms = {row["scenario"]: row["ms"] for row in bench["scenarios"]}
        log("sweep bench ms by scenario: " + json.dumps(scenario_ms))

    # ---- 8. mapAgainstIndex over stored shards, then classify, classifyU
    mai = map_against_index(args, times, db, fq, reads, shard, card, counters,
                            dev)

    # ---- 9. the long read: its slab on the wide sweep kernel --------------
    long_info, wide_row = long_read(long_run, times, card, counters, dev,
                                    clock_mhz)
    lr_batch = long_info["launches"][l2_sweep.l2_event_sweep_batch.__name__]
    batch_row.update(launches=launches + mai["sweep_launches"] + lr_batch,
                     launches_mapDirectly=launches,
                     launches_mapAgainstIndex=mai["sweep_launches"],
                     launches_long_read=lr_batch)

    # ---- 10. summary ------------------------------------------------------
    map_s = engine_stats["map_s"]
    summary = {
        "reads": len(reads), "reads_mappable": mappable,
        "reads_mapped": meta["ReadsMapped"],
        "mapping_reads_per_s": mappable / map_s,
        "mapDirectly_s": times["mapDirectly"], "mapping_s": map_s,
        "minhits_s": engine_stats["minhits_s"],
        "classify_s": times["classify"], "em": em_stats,
        "index_minimizers": shard.n_minimizers,
        "peak_device_bytes": peak, "oracle_fallbacks": fallbacks,
        "l2_candidates": engine_stats["l2_candidates"],
        "sweep_launches": launches, "phase_s": times,
        "mapping_phase_s": breakdown, "sweep_bench_ms": scenario_ms,
        "sm_clock_max_mhz": clock_mhz, "map_against_index": mai,
        "long_read": long_info, "card": card,
    }
    log("summary " + json.dumps(summary))
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [batch_row] + variant_rows + [wide_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


_POOLS: list = []  # worker pools, stopped however the run ends

if __name__ == "__main__":
    # a SIGTERM (a time limit) ends the run through the finally below
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        sys.exit(main())
    finally:
        for _pool in _POOLS:
            _pool.terminate()
            _pool.join()
