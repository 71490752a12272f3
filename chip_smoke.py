#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``metamaps_tpu_torch``) on one
NVIDIA card: builds the L2 sweep kernels from ``metamaps_tpu_torch/csrc``,
holds each against its plain PyTorch version, drives the port's main path
-- ``mapDirectly`` followed by ``classify`` (EM rounds on the card) through
the port's CLI -- on a mock-community-scale synthetic database, checks the
outputs, then drives the sweep bench, the path of the other sweep kernels,
and then the lab's day-to-day path on the same data: ``index`` into stored
shards, ``mapAgainstIndex``, ``classify`` and ``classifyU``; then a long
read, the mesh, and last the repo's at-scale accuracy experiment
(ACCURACY.json's ``synthDB`` + ``experiments``) on the card.

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
   1280, 3584; eager s_pad 1024, 2048, 10240); CUDA-event timings; the
   read sketch kernel (csrc/sketch.cu) on the first read chunk and at the
   benchmark's chunk shapes (SKETCH_SHAPES), each against its torch chain,
   with the peak device memory a call of each adds; every mapping phase
   after it reports the sketch kernel's launches and fails without one;
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
   kernel's shared-memory planes take (``BATCH_SP_MAX``), so its slab is
   swept on the card by the wide kernel (planes in device memory, each
   candidate's events split into chunks swept at once); then the same read
   at ``--pi 75 --window 3``, whose minimum hits (~250) are past the JAX
   detector's shift limit of 32 (the JAX engine sends it to the serial
   oracle, ~550 s), timed through the CLI; checks: in both runs the wide
   kernel ran, no oracle fallback, the read maps where it was drawn, and
   the wide kernel equals its plain version bit for bit on the read's real
   slab and on random and paired streams at widths up to the widest
   bucket's plane, and its own default output at two forced chunk
   lengths; for the record, the batch and wide kernels on one
   setup-shaped candidate of 150,000 events at sp = BATCH_SP_MAX (equal
   outputs, both times);
10. mesh: the multi-device spatial path on eight ranks of the one card
   (``ShardedMapperEngine`` at shard=4,data=2 on the phase-4 index: four
   contig blocks, each block's tables on two ranks), each block through
   the shard loop's writer into its own file, then ``unify_files`` (first the same code on one rank of
   the whole index, for the time within this call and phase 4's bytes);
   checks: the batch sweep kernel ran,
   oracle fallbacks <= 1% of mappable reads, >= 90% of reads mapped, .meta
   adds up, a 32-read sample gives byte-identical mapping and .meta files
   with the serial oracle over the same four partitions (the shard loop's
   writer with its oracle engine per partition, then unify; eight worker
   processes, one per partition and half-sample), device
   memory back at its level before the phase; for the record the lines
   that differ from the phase-4 output (a block's own frequency threshold
   can differ from the whole index's), seconds, reads/s, peak memory and
   device table bytes; then ``mapDirectly --mesh shard=1,data=1`` through
   the CLI on the long read's reference equals phase 9's bytes, and
   ``classify --emBackend sharded`` (through the CLI: one rank on the one
   card; and over four ranks of it) writes the ``--emBackend numpy``
   bytes in all seven .EM* files (the sharded round's time at 1M and 12M
   lines is in phase 5's em_bench rows);
11. experiments: ACCURACY.json's run at its full size through the port's
   CLI -- ``synthDB --genera 36 --speciesPerGenus 3 --genomeLen 120000
   --seed 42`` (108 genomes, 12.96 Mbp), then ``experiments --nReads 1500
   --holdout auto6 --tools metamaps --seed 11 --meanLength 5000`` with the
   torch engine and the EM rounds on the card (simulated reads, the full
   and a six-species leave-out database, mapDirectly + classify on each,
   read- and distribution-level validation); checks: the accuracy bands of
   tests/test_accuracy_artifact.py:37-62, the batch kernel ran, oracle
   fallbacks <= 1% of mappable reads, and a 64-read sample of each variant
   gives the torch engine's lines with the serial oracle (the phase-5
   worker pool); prints its results against ACCURACY.json's, key by key,
   and its seconds (synthDB, simulate, reduced DB, and per variant the
   index build and unify, the mapping loop, classify, the evaluation);
12. tools: the host tools users run on what the card wrote, through the
   port's CLI: ``geneLevelAnalysis`` and ``filterWIMP`` (at 0.8 and 0.999)
   on phase 4's ``mapDirectly`` -> ``classify`` output, after a
   ``DB_annotations.txt`` (a gene every few kb of every contig) and a
   ``DB_proteins.faa.annotated`` made from ``--seed``; ``convertDB`` to
   kraken, centrifuge and mash on phase 4's database; ``splitEggNog``
   split -> submit -> collect on a protein FASTA made from ``--seed`` (the
   job scripts run an annotation stand-in, as emapper.py is not
   installed); ``evaluateExternal`` on phase 11's full-database run
   against its truth; ``plotIdentities`` and ``evaluateExternal --plots``
   where matplotlib is installed. Checks: every gene row has a read and a
   median identity in [0, 1], the reads with and without an annotated
   contig add up to the reads in .EM, 0.999 leaves every read
   unclassified, every kraken header carries its taxon, one
   seqid2taxid.map line per contig, one mash FASTA per taxon, the chunks
   hold the input's records and residues, one collected row per protein,
   the reads counted are the truth's and every accuracy lies in [0, 1];
   each subcommand's seconds;
13. at_scale: the repo's 1 Gbp run through the port's bench
   (``metamaps_tpu_torch/profiling/bench.py``): the structured database
   (seed 20260820, 1 Gbp) winnowed, finalized and stored as an index
   under the work directory, the shard's tables uploaded, and its 16,384
   reads mapped with the bench's engine (hit capacity 16,384): two warm
   passes on 256 reads, one on all, three timed; one pass more at each
   bucket's own hit capacity (its fallbacks recorded); the union with
   mapping qualities; the EM round at 1M synthetic lines and on the union
   tiled to 5M lines, each against the host round; ``mapAgainstIndex``
   through the CLI on the first 2048 reads of the stored index (the
   index's one restore). Checks: the batch kernel ran, oracle fallbacks
   <= 1%, >= 90% of reads mapped, both capacities give the same
   mappings, the CLI's lines equal the bench's union for those reads, the
   EM rounds agree with the host's, the batch kernel equals its plain
   version bit for bit on the first 1 Gbp slab (its time and bound on
   every slab of that chunk), and a 64-read sample gives the serial
   oracle's lines (worker processes forked after every timed step, which
   share the shard); for the record, each mapping phase's seconds in a
   fresh engine that synchronises after each;
14. u_at_scale: the novel-species chain on phase 13's mappings through
   ``metamaps_tpu_torch/profiling/u_at_scale.py``: the 16,384-read union
   dumped with its sidecars, the database directory written around the
   same genomes (re-synthesised), then ``classify`` (EM rounds on the
   card, then ``--emBackend numpy`` on a copy), ``selfSimilarity`` on the
   two jobs with the fewest B bases (the JAX script's reduced workload,
   in two worker processes), ``collect`` and ``classifyU``. Checks: the
   seven .EM* files byte-identical on the card and the host, one
   .U.reads2Taxon row per read, .U.WIMP not empty, no job's histogram
   counts more chunks of a length than it drew, every identity between
   the floor that the acceptance rule admits at its chunk length
   (``u_at_scale.identity_floor``: 73; a chunk maps where its identity's
   upper bound reaches 80) and 100;
   each step's seconds beside the card's name and power limit;
15. summary: reads/s of every mapping path, classify seconds, peak device
   memory, the tools' seconds, the 1 Gbp run's and the U chain's numbers,
   then the card line, the kernel JSON line and the final JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
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
from metamaps_tpu_torch.db import self_similarity as ss
from metamaps_tpu_torch.engine import em, mapper_oracle
from metamaps_tpu_torch.engine.index import (
    SketchShard,
    build_shards,
    create_index,
    load_index_manifest,
    reference_memory_model,
)
from metamaps_tpu_torch.engine.mapper_torch import MapConfig, TorchMapperEngine
from metamaps_tpu_torch.io.fasta import read_sequences
from metamaps_tpu_torch.io.mappings import (MappingLine, iter_reads_grouped,
                                            parse_mapping_line, read_meta)
from metamaps_tpu_torch.io.native import winnow_native
from metamaps_tpu_torch.ops import l1, l2_sweep, l2_sweep_parts
from metamaps_tpu_torch.ops.sketch import sketch, sketch_ref
from metamaps_tpu_torch.engine.mapwrap import (map_query_file_against_shard,
                                               unify_query_file)
from metamaps_tpu_torch.parallel.sharded_engine import (ShardedMapperEngine,
                                                        map_query_file_sharded)
from metamaps_tpu_torch.params import Parameters
from metamaps_tpu_torch.profiling import (bench, em_bench, sweep_bench,
                                          u_at_scale)
from metamaps_tpu_torch.profiling.bench import write_fastq
from metamaps_tpu_torch.profiling.sweep_ab import LONG_READ, LONG_READ_ARGS
from metamaps_tpu_torch.sim.synth_db import ont_read, write_synth_db_dir
from metamaps_tpu_torch.taxonomy import extract_taxon_id

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
# LONG_READ (62 kb): at w = 3 its planes are wider than BATCH_SP_MAX, at
# LONG_READ_ARGS' --pi 60 and at LONG_READ_PI75's --pi 75, whose minimum
# hits (~250) pass the JAX detector's shift limit (32): the JAX engine
# sends the read to the serial oracle there (~550 s), the port sweeps it
LONG_READ_PI75 = ["--pi", "75", "--window", "3"]
WIDE_STREAM_WIDTHS = (28928, 41088)  # just above BATCH_SP_MAX; widest bucket
WIDE_FORCED_CHUNKS = (256, 2048)  # chunk lengths held against the default
SETUP_EVENTS = 150_000  # one setup-shaped candidate at sp = BATCH_SP_MAX
# the sketch kernel beside its torch chain at the benchmark's chunk shapes:
# zymo.ont_files' largest bucket chunk, zymo.ont_minknow4k's and a 500-read
# file as one chunk of the 8192 bucket (as a merge of under-filled buckets
# would make it): (name, reads, bucket, shortest read, longest read)
SKETCH_SHAPES = (("ont_files_7168", 111, 7168, 6145, 7168),
                 ("minknow4k_7168", 890, 7168, 6145, 7168),
                 ("merged_500_8192", 500, 8192, 3000, 7600))
# --minreads of classify and classifyU: U fits its identity model on a
# contig with more assigned reads than this (the default, 10000, is a real
# sample's); 4096 reads put ~110 on each of the 36 genomes
U_MIN_READS = "50"
MESH = (4, 2)  # shard, data: eight ranks on the one card
# reads per rank per chunk: global chunks of 1024 reads, the single-device
# engine's CHUNK (the CLI's default of 32 is the JAX package's)
MESH_ROWS = 512
MESH_ORACLE_WORKERS = 2  # worker processes per partition for the sample,
# each mapping its share of the sample's reads
# the mesh's oracle sample: half the others', to leave phase 13 its time
MESH_SAMPLE = 32
EM_SHARDED_RANKS = 4
# phase 11: ACCURACY.json's command at its full size (its "db" builder and
# "command"), through the port's CLI on the card
ACC_SYNTH_ARGS = ["--genera", "36", "--speciesPerGenus", "3", "--genomeLen",
                  "120000", "--seed", "42"]
ACC_EXPERIMENT_ARGS = ["--name", "acc", "--nReads", "1500", "--holdout",
                       "auto6", "--tools", "metamaps", "--seed", "11",
                       "--meanLength", "5000"]
ACC_MIN_READ_LEN = 2000  # experiments' --minReadLen default
# the bands of tests/test_accuracy_artifact.py:37-62 over results.json
ACC_FULL_MIN_READS = 1000  # full DB: reads with an absolute assignment
ACC_FULL_MIN = 0.95  # full DB: absolute and species accuracy
ACC_HOLDOUT_ABSOLUTE_MIN = 0.80  # leave-out DB: all reads, absolute
ACC_NOVEL_MIN_READS = 20  # leave-out DB: reads of the removed species
ACC_NOVEL_ABSOLUTE_MAX = 0.05
ACC_NOVEL_GENUS_MIN = 0.5
ACC_IN_DB_SPECIES_MIN = 0.95  # leave-out DB: reads of species in the DB
ACC_SPECIES_L1_MAX = 0.3  # both variants: composition distances
ACC_GENUS_L1_MAX = 0.25
ACC_GENUS_RECALL_MIN = 0.8
ACC_SAME_REL = 1e-12  # a float that differs only in its last bits
# phase 12: a gene of 600-2400 bases every TOOLS_GENE_STEP bases of every
# contig; a protein FASTA of TOOLS_PROTEINS records of 100-600 residues,
# split into chunks of about TOOLS_TARGET_CHARS characters
TOOLS_GENE_STEP = 3000
TOOLS_PROTEINS = 20000
TOOLS_TARGET_CHARS = 1_000_000
# the annotation stand-in the job scripts run: the chunk's emapper table
# (three comment lines, the header, one row per protein)
FAKE_EMAPPER = """import sys
inp, out = sys.argv[1], sys.argv[2]
with open(out + ".emapper.annotations", "w") as o:
    o.write("# stand-in\\n#\\n#\\n#query_name\\tGO_terms\\tKEGG_KOs\\t"
            "BiGG_reactions\\tOGs\\tCOG cat\\n")
    for line in open(inp):
        if line.startswith(">"):
            pid = line[1:].split()[0]
            n = int(pid.split("_")[1].split(".")[0])
            o.write(f"{pid}\\tGO:{n % 97:07d}\\tK{n % 1000:05d}\\t\\t"
                    f"COG{n % 211:04d}\\t{'JKLDVT'[n % 6]}\\n")
"""

# phase 13: the 1 Gbp run; reads of the stored-index check, and the
# oracle sample's worker processes (forked: they share the ~1 GB shard)
SCALE_MAI_READS = 2048
SCALE_ORACLE_WORKERS = 8
# phase 14: the selfSimilarity jobs run (those with the fewest B bases),
# each in its own worker process
U_SCALE_JOBS = 2

# the serial oracle takes seconds per read at this database size, so a
# sample is mapped by a pool of workers: spawned ones load the shard from
# disk (_oracle_worker_init), forked ones find it here
_worker_state: dict = {}


def _oracle_worker_init(shard_path: str, params) -> None:
    _worker_state["shard"] = SketchShard.load(shard_path)
    _worker_state["params"] = params


def _oracle_map(seq):
    return mapper_oracle.map_read(_worker_state["shard"],
                                  _worker_state["params"], seq)


def _oracle_part_worker(part_path: str, params, query: str, out: str):
    """The shard loop's writer with the serial oracle engine, for one
    partition stored at ``part_path``, in a spawned worker process."""
    map_query_file_against_shard(SketchShard.load(part_path), params, query,
                                 out, engine="oracle")


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


def compare(label, fn, ref, arrs, *width, timed: dict = None, locate=None,
            plain: dict = None):
    """A kernel wrapper ``fn`` against its plain version ``ref`` on the same
    CUDA tensors; returns the max abs difference. Exact int32 arithmetic:
    any difference fails. ``timed``, when given, gets the plain call's
    milliseconds by CUDA events (``plain_ms``); ``locate(got, want)``, when
    given, says where a difference comes from before the failure;
    ``plain``, when given, keeps the plain version's output by width for
    the next kernel on the same inputs (the plain sweep takes seconds)."""
    got = fn(*arrs, *width)
    torch.cuda.synchronize()
    if plain is not None and width in plain:
        want = plain[width]
    else:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = ref(*arrs, *width)
        end.record()
        torch.cuda.synchronize()
        if timed is not None:
            timed["plain_ms"] = start.elapsed_time(end)
        if plain is not None:
            plain[width] = want
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
                 ref, sp=None, bound=None, plain_ms=None, shape=None,
                 **extra):
    """One row of the kernels line: the kernel's and the plain version's
    CUDA-event times on ``arrs`` (``plain_ms`` where the caller timed it
    already) and the bound on the same inputs, from the work this data
    needs: ``bound`` (ms, bound_by, counts) where given, else
    ``sweep_bench.sweep_bound`` with ``sp``, and then the row also carries
    the bound with every event recounted and the events in each mode.
    ``shape`` defaults to a sweep's [N, E2, width]."""
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
                shape=shape or [int(arrs[1].shape[0]), int(arrs[1].shape[1]),
                                width[0]], **extra)


def sketch_chunk(rng, B, bucket, lo, hi):
    """ONT-like reads of ``lo``-``hi`` random bases (a sixth of them with a
    stretch of lower case and one of N), right-padded with A as the engine
    pads them: (reads [B, bucket] uint8, lens [B] int64)."""
    lens = rng.integers(lo, hi + 1, B)
    reads = np.full((B, bucket), ord("A"), np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.choice(bases, size=n)
        if i % 6 == 0:
            reads[i, 100:400] += 32
            reads[i, 900:950] = ord("N")
    return reads, lens.astype(np.int64)


def sketch_bound(lens, L: int, k: int, S: int, clock_mhz: float):
    """(ms, bound_by, counts) of sketching reads of ``lens`` padded to
    ``L``: the larger of the bytes (the reads in, S hashes and strands a
    read out) at sweep_bench's HBM rate and the 32-bit integer operations
    (two MurmurHash3_x64_128 calls a k-mer position: about 36 a 16-byte
    block, 44 in the finalisers and around them, the 64-bit multiplies as
    three 32-bit multiply-adds; the byte words and the window minima left
    out) at the CUDA cores' INT32 rate, as ``sweep_bench.sweep_bound``."""
    positions = int(np.maximum(np.asarray(lens) - k + 1, 0).sum())
    int_ops = 2 * (36 * -(-k // 16) + 44) * positions
    n_bytes = len(lens) * (L + S * 9)
    ops_ms = 1e3 * int_ops / (sweep_bench.SMS * sweep_bench.INT32_LANES
                              * clock_mhz * 1e6)
    bytes_ms = 1e3 * n_bytes / sweep_bench.HBM_BYTES_PER_S
    return (max(ops_ms, bytes_ms), "ops" if ops_ms >= bytes_ms else "bytes",
            dict(positions=positions, int_ops=int_ops, bytes=n_bytes))


def peak_mib(fn, dev) -> float:
    """The device memory one call of ``fn`` adds at its peak, in MiB."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**20


def sketch_entry(label, reads, lens, k, w, S, a, dev, clock_mhz):
    """The sketch kernel against its torch chain on the same card tensors,
    every output equal bit for bit (else the smoke fails), then its kernels
    line row: times, bound and the peak memory a call of each adds."""
    arrs = [torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)]
    before = sketch.launches
    got = sketch(*arrs, k, w, S, a)
    want = sketch_ref(*arrs, k, w, S, a)
    torch.cuda.synchronize(dev)
    if sketch.launches != before + 1:
        raise AssertionError(f"the sketch kernel did not run on {label}")
    for name, g, w_ in zip(("q_hash", "q_strand", "size", "overflow"), got,
                           want):
        if g.dtype != w_.dtype or not torch.equal(g, w_):
            raise AssertionError(f"sketch differs from its torch chain in "
                                 f"{name} on {label}")
    B, L = reads.shape
    log(f"sketch vs torch chain, {label}: B={B} L={L} S={S} k={k} w={w}: "
        "equal")
    return kernel_entry(
        "sketch", "metamaps_tpu_torch/csrc/sketch.cu",
        "metamaps_tpu/ops/batch_map.py:909 (XLA)", arrs, (k, w, S, a),
        clock_mhz, 0, sketch, sketch_ref,
        bound=sketch_bound(lens, L, k, S, clock_mhz), shape=[B, L, S],
        label=label, peak_mib=peak_mib(lambda: sketch(*arrs, k, w, S, a), dev),
        plain_peak_mib=peak_mib(lambda: sketch_ref(*arrs, k, w, S, a), dev))


def format_maps(maps, shard, read_id: str) -> list:
    """Unfiltered mappings of one read as mapping lines."""
    return [MappingLine(
        read_id=read_id, read_len=m.query_len, strand=m.strand,
        contig_id=shard.contig_names[m.ref_seqid],
        contig_len=shard.contig_lengths[m.ref_seqid],
        ref_start=m.ref_start, ref_end=m.ref_end,
        identity=m.nuc_identity, intersection=m.conserved,
        sketch_size=m.sketch_size).format() for m in maps]


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
    mai_sketch = sketch.launches
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
            sweep_launches=mai_launches, sketch_launches=mai_sketch,
            device_bytes_before=mem_before,
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
    info["pi75"] = long_read_pi75(run, times, card, counters)
    return info, row


def long_read_pi75(run: dict, times: dict, card: str, counters) -> dict:
    """The long read at ``LONG_READ_PI75`` through the CLI: past the JAX
    detector's shift limit, swept by the wide kernel. Returns its numbers."""
    out = os.path.join(run["dir"], "out_pi75")
    argv = ["mapDirectly", "--reference", run["ref"], "--query", run["fq"],
            "--output", out, "--all", "--mapping-engine", "torch",
            *LONG_READ_PI75]
    params = sketch_params(argv[1:])
    k, w = params.kmer_size, params.window_size
    sketch_size = mapper_oracle.sketch_read(run["read"], k, w)[0].size
    minhits = int(l1.minhits_table(sketch_size, k,
                                   params.percentage_identity)[sketch_size])
    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    stats: dict = {}
    with Phase("long_read_pi75", times):
        if cli_main(argv, engine_stats=stats) != 0:
            raise AssertionError("mapDirectly on the long read at --pi 75 "
                                 "failed")
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    with open(out) as f:
        lines = [parse_mapping_line(line) for line in f]
    info = dict(args=LONG_READ_PI75, sketch=sketch_size, minhits=minhits,
                lines=len(lines), launches=launches,
                oracle_fallbacks=stats["oracle_fallbacks"],
                map_s=stats["map_s"], minhits_s=stats["minhits_s"],
                mapDirectly_s=times["long_read_pi75"], card=card)
    log("long read at --pi 75 " + json.dumps(info) + "; the serial oracle "
        "took ~550 s for this read (PERF.md §6)")
    if minhits <= 32:
        raise AssertionError(f"minimum hits {minhits} at --pi 75: within "
                             "the JAX detector's shift limit")
    if launches[l2_sweep.l2_event_sweep_wide.__name__] <= 0:
        raise AssertionError("the wide sweep kernel never ran on the long "
                             "read at --pi 75")
    if stats["oracle_fallbacks"] != 0 or stats["reads_mappable"] != 1:
        raise AssertionError("the long read at --pi 75 went to the oracle")
    if not lines:
        raise AssertionError("the long read at --pi 75 did not map")
    best = max(lines, key=lambda m: m.intersection)
    if (best.contig_id != run["contig"]
            or abs(best.ref_start - run["pos"]) > LONG_READ // 20):
        raise AssertionError(f"the long read at --pi 75 mapped to "
                             f"{best.contig_id}:{best.ref_start}, drawn at "
                             f"{run['pos']}")
    return info


def mesh_phase(args, times: dict, db: str, fq: str, reads, shard, params,
               out_single: str, card: str, counters, dev) -> dict:
    """Map ``fq`` with ``ShardedMapperEngine`` at ``MESH`` on ranks of
    ``dev`` over the main path's index ``shard``, check the run, and hold a
    sample against the serial oracle on the same partitions. Returns the
    numbers of the run."""
    n_shard, n_data = MESH
    params = Parameters(**{**params.__dict__})
    params.report_all = True  # the main path's --all
    out_mesh = os.path.join(args.workdir, "mesh", "out")
    os.makedirs(os.path.dirname(out_mesh), exist_ok=True)
    # the same code on one rank of the whole index first: what the
    # partition costs, within this call, and the phase-4 bytes
    out_1x1 = os.path.join(args.workdir, "mesh", "out_1x1")
    stats_1x1: dict = {}
    l1._MINHITS.clear()
    with Phase("mesh_1x1", times):
        engine = ShardedMapperEngine(shard, params, 1, 1,
                                     rows_per_device=MESH_ROWS * n_data,
                                     devices=[dev])
        map_query_file_sharded(engine, params, fq, out_1x1,
                               engine_stats=stats_1x1)
        torch.cuda.synchronize()
    del engine
    for suffix in ("", ".meta"):
        if not same_bytes(out_single + suffix, out_1x1 + suffix):
            raise AssertionError(f"the mesh at shard=1,data=1{suffix} differs "
                                 "from mapDirectly")
    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with Phase("mesh_engine", times):
        engine = ShardedMapperEngine(shard, params, n_shard, n_data,
                                     rows_per_device=MESH_ROWS,
                                     devices=[dev] * (n_shard * n_data))
        torch.cuda.synchronize()
    stats: dict = {}
    with Phase("mesh", times):
        map_query_file_sharded(engine, params, fq, out_mesh,
                               engine_stats=stats)
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated(dev)

    with Phase("mesh_checks", times):
        meta = read_meta(out_mesh)
        mappable = meta["TotalReads"] - meta["ReadsTooShort"]
        batch = l2_sweep.l2_event_sweep_batch.__name__
        info = dict(
            card=card, mesh=dict(shard=n_shard, data=n_data),
            rows_per_device=MESH_ROWS, devices=[str(dev)] * (n_shard * n_data),
            part_minimizers=[p.n_minimizers for p in engine.parts],
            part_contigs=[len(p.contig_names) for p in engine.parts],
            part_freq_thresholds=[p.freq_threshold for p in engine.parts],
            whole_freq_threshold=shard.freq_threshold,
            device_table_bytes=sum(e.tables.nbytes() for row in engine.engines
                                   for e in row),
            engine_s=times["mesh_engine"], mesh_s=times["mesh"],
            mapping_s=stats["map_s"], minhits_s=stats["minhits_s"],
            mapping_reads_per_s=mappable / stats["map_s"],
            oracle_fallbacks=stats["oracle_fallbacks"],
            reads_mappable_over_blocks=stats["reads_mappable"],
            l2_candidates=stats["l2_candidates"], l2_slabs=stats["l2_slabs"],
            launches=launches, peak_device_bytes=peak,
            mapping_s_1x1=stats_1x1["map_s"],
            mapping_reads_per_s_1x1=mappable / stats_1x1["map_s"],
            l2_slabs_1x1=stats_1x1["l2_slabs"],
            device_bytes_before=mem_before, meta=meta)
        if launches[batch] <= 0:
            raise AssertionError("the sweep kernel never ran on the mesh")
        if (stats["oracle_fallbacks"]
                > 0.01 * info["reads_mappable_over_blocks"]):
            raise AssertionError(f"{stats['oracle_fallbacks']} oracle "
                                 "fallbacks on the mesh")
        if meta["TotalReads"] != (meta["ReadsTooShort"] + meta["ReadsMapped"]
                                  + meta["ReadsNotMapped"]):
            raise AssertionError("mesh .meta does not add up")
        if meta["TotalReads"] != len(reads):
            raise AssertionError("mesh .meta TotalReads differs")
        if meta["ReadsMapped"] < 0.9 * len(reads):
            raise AssertionError(f"the mesh mapped only {meta['ReadsMapped']} "
                                 "reads")
        # for the record: where the blocks' own thresholds change lines
        with open(out_single) as a, open(out_mesh) as b:
            single, mesh = set(a), set(b)
        info.update(lines=len(mesh), lines_only_single=len(single - mesh),
                    lines_only_mesh=len(mesh - single),
                    reads_differing=len({l.split(" ", 1)[0]
                                         for l in single ^ mesh}))
        # the sample: the mesh engine against the serial oracle on the same
        # four partitions, through the same writer and unify; each
        # partition's oracle run split over MESH_ORACLE_WORKERS processes
        # by reads (a read's lines do not depend on the others)
        sdir = os.path.join(args.workdir, "mesh_sample")
        os.makedirs(sdir, exist_ok=True)
        sample_fq = os.path.join(sdir, "sample.fastq")
        write_fastq(sample_fq, reads[:MESH_SAMPLE])
        outs = {e: os.path.join(sdir, e) for e in ("torch", "oracle")}
        map_query_file_sharded(engine, params, sample_fq, outs["torch"])
        step = -(-MESH_SAMPLE // MESH_ORACLE_WORKERS)
        pieces = []
        for w in range(MESH_ORACLE_WORKERS):
            pieces.append(os.path.join(sdir, f"sample{w}.fastq"))
            write_fastq(pieces[-1],
                        reads[w * step:min((w + 1) * step, MESH_SAMPLE)],
                        first=w * step)
        jobs, part_files = [], []
        with ProcessPoolExecutor(
                n_shard * MESH_ORACLE_WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            for i, part in enumerate(engine.parts):
                path = os.path.join(sdir, f"part{i}.npz")
                part.save(path)
                part_files.append(f"{outs['oracle']}.{i}")
                for w, piece in enumerate(pieces):
                    jobs.append(pool.submit(_oracle_part_worker, path, params,
                                            piece, f"{part_files[-1]}.{w}"))
            for job in jobs:
                job.result()
        for path in part_files:
            with open(path, "w") as out:
                for w in range(MESH_ORACLE_WORKERS):
                    with open(f"{path}.{w}") as f:
                        out.write(f.read())
                    os.remove(f"{path}.{w}")
        unify_query_file(outs["oracle"], sample_fq, params, part_files)
        for suffix in ("", ".meta"):
            if not same_bytes(outs["torch"] + suffix, outs["oracle"] + suffix):
                raise AssertionError(f"mesh sample{suffix}: the torch engine "
                                     "and the oracle differ")
        with open(outs["oracle"]) as f:
            info["sample_lines"] = sum(1 for _ in f)
        log(f"{MESH_SAMPLE}-read sample over the mesh's {n_shard} partitions: "
            f"{info['sample_lines']} mapping lines and .meta byte-identical "
            f"with the torch engine and the serial oracle "
            f"({n_shard} x {MESH_ORACLE_WORKERS} workers)")
        del engine
        gc.collect()
        torch.cuda.synchronize()
        info["device_bytes_after"] = mem_after = torch.cuda.memory_allocated(dev)
        log("mesh " + json.dumps(info))
        if mem_after != mem_before:
            raise AssertionError(f"device memory {mem_after} B after the "
                                 f"mesh, {mem_before} B before")
    return info


def mesh_cli_and_em(long_run: dict, times: dict, db: str, out_mesh: str,
                    counters, dev) -> dict:
    """``mapDirectly --mesh shard=1,data=1`` through the CLI against phase
    9's run without it, then ``classify --emBackend sharded`` on the mesh
    output (through the CLI, and over ``EM_SHARDED_RANKS`` ranks of ``dev``)
    against ``--emBackend numpy``."""
    info: dict = {}
    with Phase("mesh_cli", times):
        out1 = os.path.join(long_run["dir"], "out")
        out_m = os.path.join(long_run["dir"], "out_mesh")
        for fn in counters:
            fn.launches = 0
        if cli_main(["mapDirectly", "--reference", long_run["ref"], "--query",
                     long_run["fq"], "--output", out_m, "--all",
                     *LONG_READ_ARGS, "--mesh", "shard=1,data=1",
                     "--device", "cuda"]) != 0:
            raise AssertionError("mapDirectly --mesh failed")
        torch.cuda.synchronize()
        info["cli_launches"] = {fn.__name__: fn.launches for fn in counters}
        for suffix in ("", ".meta", ".meta.unmappedReadsLengths"):
            if not same_bytes(out1 + suffix, out_m + suffix):
                raise AssertionError(f"mapDirectly --mesh shard=1,data=1 "
                                     f"{suffix}: differs from the run without")
        log("mapDirectly --mesh shard=1,data=1 on the long read: the bytes of "
            f"the run without --mesh; launches {info['cli_launches']}")
    with Phase("mesh_em", times):
        runs = {}
        for name in ("numpy", "sharded_cli", "sharded_ranks"):
            d = os.path.join(os.path.dirname(out_mesh), name)
            os.makedirs(d, exist_ok=True)
            for suffix in ("", ".meta", ".meta.unmappedReadsLengths"):
                shutil.copy(out_mesh + suffix, d)
            runs[name] = os.path.join(d, "out")
        for name, backend in (("numpy", "numpy"), ("sharded_cli", "sharded")):
            t0 = time.perf_counter()
            if cli_main(["classify", "--DB", db, "--mappings", runs[name],
                         "--emBackend", backend]) != 0:
                raise AssertionError(f"classify --emBackend {backend} failed")
            info[f"classify_{name}_s"] = time.perf_counter() - t0
        p_em = Parameters()
        p_em.db, p_em.minimum_reads_for_u = db, 10000
        t0 = time.perf_counter()
        em.do_em(p_em, runs["sharded_ranks"], em_backend="sharded",
                 device=[dev] * EM_SHARDED_RANKS)
        info["classify_sharded_ranks_s"] = time.perf_counter() - t0
        for name in ("sharded_cli", "sharded_ranks"):
            for suffix in EM_FILES:
                if not same_bytes(runs["numpy"] + suffix, runs[name] + suffix):
                    raise AssertionError(f"{suffix}: the sharded EM ({name}) "
                                         "and the host EM differ")
        log(f"classify --emBackend sharded (CLI: {torch.cuda.device_count()} "
            f"rank(s); and {EM_SHARDED_RANKS} ranks of {dev}): 7 .EM* files "
            "identical to --emBackend numpy; " + json.dumps(info))
    return info


def accuracy_band_failures(results: dict) -> list:
    """Where ``results`` (an ``experiments`` results.json) leaves the bands
    of tests/test_accuracy_artifact.py:37-62; empty when it is inside."""
    full = results["full__metamaps"]["reads"]["ALL"]
    hold = results["holdout__metamaps"]["reads"]
    checks = [
        ("full absolute N", full["absolute"]["N"], ">=", ACC_FULL_MIN_READS),
        ("full absolute accuracy", full["absolute"]["accuracy"], ">=",
         ACC_FULL_MIN),
        ("full species accuracy", full["species"]["accuracy"], ">=",
         ACC_FULL_MIN),
        ("holdout absolute accuracy", hold["ALL"]["absolute"]["accuracy"],
         ">=", ACC_HOLDOUT_ABSOLUTE_MIN),
        ("novel absolute N", hold["novel"]["absolute"]["N"], ">=",
         ACC_NOVEL_MIN_READS),
        ("novel absolute accuracy", hold["novel"]["absolute"]["accuracy"],
         "<=", ACC_NOVEL_ABSOLUTE_MAX),
        ("novel genus accuracy", hold["novel"]["genus"]["accuracy"], ">=",
         ACC_NOVEL_GENUS_MIN),
        ("in-DB species accuracy", hold["truthLeafInDB"]["species"]["accuracy"],
         ">=", ACC_IN_DB_SPECIES_MIN),
    ]
    for key in ("full__metamaps", "holdout__metamaps"):
        d = results[key]["distribution"]
        checks += [(f"{key} species L1", d["species"]["L1"], "<=",
                    ACC_SPECIES_L1_MAX),
                   (f"{key} genus L1", d["genus"]["L1"], "<=",
                    ACC_GENUS_L1_MAX),
                   (f"{key} genus binary recall", d["genus"]["binary_recall"],
                    ">=", ACC_GENUS_RECALL_MIN)]
    return [f"{name} {value} (band {op} {limit})"
            for name, value, op, limit in checks
            if not (value >= limit if op == ">=" else value <= limit)]


def flat_items(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of nested dicts."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key, value in tree.items():
        out.update(flat_items(value, f"{prefix}/{key}" if prefix else key))
    return out


def same_value(a, b, rel: float = 0.0) -> bool:
    """Equality of two JSON leaves within ``rel`` (relative, floats only),
    NaN equal to NaN (r2 of a level with one taxon)."""
    if isinstance(a, float) and isinstance(b, float):
        if a != a or b != b:
            return a != a and b != b
        return abs(a - b) <= rel * max(abs(a), abs(b))
    return type(a) is type(b) and a == b


def mapping_lines_by_read(path: str) -> dict:
    """{read id: its lines' first 12 fields} of a mappings file (the fields
    the engine writes; unify appends the mapping qualities)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            fields = line.split(" ")
            out.setdefault(fields[0], []).append(" ".join(fields[:12]))
    return out


def oracle_sample(db: str, reads_fq: str, mappings: str, workdir: str,
                  ) -> tuple:
    """The first ``SAMPLE`` mappable reads of ``reads_fq`` mapped by the
    serial oracle against ``db`` (the index ``mapDirectly --all
    --minReadLen ACC_MIN_READ_LEN`` builds, in the smoke's worker pool),
    held against their lines in ``mappings``. Returns (reads, lines)."""
    db_fa = os.path.join(db, "DB.fa")
    params = sketch_params(["--reference", db_fa, "--minReadLen",
                            str(ACC_MIN_READ_LEN)])
    params.report_all = True
    shards = []
    build_shards(params, 0, lambda sh, n: shards.append(sh))
    shard = shards[0]
    shard_path = os.path.join(workdir, "shard.npz")
    os.makedirs(workdir, exist_ok=True)
    shard.save(shard_path)
    sample = []
    for name, seq in read_sequences(reads_fq):
        if len(seq) >= max(params.window_size, params.kmer_size,
                           params.min_read_length):
            sample.append((name, seq))
            if len(sample) == SAMPLE:
                break
    workers = min(8, os.cpu_count() or 1)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_oracle_worker_init,
            initargs=(shard_path, params)) as pool:
        maps = list(pool.map(_oracle_map, [seq for _, seq in sample]))
    torch_lines = mapping_lines_by_read(mappings)
    n_lines = 0
    for (name, _), ms in zip(sample, maps, strict=True):
        want = [MappingLine(
            read_id=name, read_len=m.query_len, strand=m.strand,
            contig_id=shard.contig_names[m.ref_seqid],
            contig_len=shard.contig_lengths[m.ref_seqid],
            ref_start=m.ref_start, ref_end=m.ref_end,
            identity=m.nuc_identity, intersection=m.conserved,
            sketch_size=m.sketch_size).format()
            for m in mapper_oracle.report_filter(ms, report_all=True)]
        got = torch_lines.get(name, [])
        if got != want:
            raise AssertionError(f"{mappings}, {name}: torch engine {got} != "
                                 f"oracle {want}")
        n_lines += len(want)
    return len(sample), n_lines


def experiments_phase(args, times: dict, card: str, counters) -> dict:
    """ACCURACY.json's run at its full size through the port's CLI:
    ``synthDB`` and then ``experiments`` with the torch engine and the EM
    rounds on the card. Checks the bands, the batch kernel's launches, the
    oracle fallbacks and a sample of each variant against the serial
    oracle; prints the comparison with ACCURACY.json's results and where
    the time went. Returns the phase's numbers."""
    acc_db = os.path.join(args.workdir, "acc", "DB")
    store = os.path.join(args.workdir, "acc", "store")
    with Phase("acc_synthDB", times):
        if os.path.exists(os.path.dirname(acc_db)):
            shutil.rmtree(os.path.dirname(acc_db))
        if cli_main(["synthDB", "--out", acc_db, *ACC_SYNTH_ARGS]) != 0:
            raise AssertionError("synthDB failed")
    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    run_stats: dict = {}
    with Phase("experiments", times):
        if cli_main(["experiments", "--DB", acc_db, "--store", store,
                     *ACC_EXPERIMENT_ARGS, "--engine", "torch", "--device",
                     "cuda"], engine_stats=run_stats) != 0:
            raise AssertionError("experiments failed")
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}

    with Phase("experiments_checks", times):
        root = os.path.join(store, "acc")
        with open(os.path.join(root, "results.json")) as f:
            results = json.load(f)
        runs = run_stats["runs"]
        info = dict(card=card, launches=launches, seconds=dict(
            synthDB=times["acc_synthDB"], experiments=times["experiments"],
            simulate=run_stats["simulate_s"],
            reduced_db=run_stats["reduced_db_s"]["holdout"],
            **{key.split("__")[0]: dict(
                index_and_unify=r["mapDirectly_s"] - r["map_s"],
                map_s=r["map_s"], minhits_s=r["minhits_s"],
                classify=r["classify_s"], evaluate=r["evaluate_s"])
               for key, r in runs.items()}),
            reads_mappable={k: r["reads_mappable"] for k, r in runs.items()},
            reads_mapped={k: r["reads_mapped"] for k, r in runs.items()},
            oracle_fallbacks={k: r["oracle_fallbacks"]
                              for k, r in runs.items()},
            l2_candidates={k: r["l2_candidates"] for k, r in runs.items()})
        log("experiments " + json.dumps(info))
        # L1, L2 and r2 sum over a set of taxon IDs (sim/validation.py),
        # whose order follows the process's string hashes: their last bits
        # move between processes, so the comparison also counts the keys
        # equal within ACC_SAME_REL
        with open(os.path.join(ROOT, "ACCURACY.json")) as f:
            want = flat_items(json.load(f)["results"])
        got = flat_items(results)
        keys = sorted(set(want) | set(got))
        exact = [k for k in keys if k in want and k in got
                 and same_value(got[k], want[k])]
        differ = [k for k in keys if k not in want or k not in got
                  or not same_value(got[k], want[k], ACC_SAME_REL)]
        last_bits = sorted(set(keys) - set(exact) - set(differ))
        info["accuracy_json"] = dict(keys=len(keys), exact=len(exact),
                                     last_bits=last_bits, differ=differ)
        log(f"results against ACCURACY.json's results, key by key: "
            f"{len(keys)} keys, {len(exact)} equal, {len(last_bits)} equal "
            f"within {ACC_SAME_REL} relative (summation order) "
            f"{json.dumps(last_bits[:12])}, {len(differ)} differ"
            + ("" if not differ else "; first: " + json.dumps(
                [(k, got.get(k), want.get(k)) for k in differ[:12]])))
        failures = accuracy_band_failures(results)
        for key in ("full__metamaps", "holdout__metamaps"):
            r = results[key]["reads"]
            log(f"{key}: " + json.dumps({
                cat: {lv: r[cat][lv]["accuracy"] for lv in
                      ("absolute", "species", "genus")}
                for cat in r}) + "; distribution " + json.dumps(
                {lv: {m: results[key]["distribution"][lv][m]
                      for m in ("L1", "binary_recall")}
                 for lv in ("species", "genus")}))
        if failures:
            raise AssertionError("outside the accuracy bands: "
                                 + "; ".join(failures))
        if launches[l2_sweep.l2_event_sweep_batch.__name__] <= 0:
            raise AssertionError("the batch sweep kernel never ran in "
                                 "experiments")
        mappable = sum(info["reads_mappable"].values())
        fallbacks = sum(info["oracle_fallbacks"].values())
        if fallbacks > 0.01 * mappable:
            raise AssertionError(f"{fallbacks} oracle fallbacks of "
                                 f"{mappable} mappable reads")
        info["sample"] = {}
        for variant, db in (("full", acc_db),
                            ("holdout", os.path.join(root, "dbs", "holdout"))):
            n_reads, n_lines = oracle_sample(
                db, os.path.join(root, "reads.fastq"),
                os.path.join(root, "runs", f"{variant}__metamaps", "out"),
                os.path.join(args.workdir, "acc", f"sample_{variant}"))
            info["sample"][variant] = dict(reads=n_reads, lines=n_lines)
        log(f"{SAMPLE}-read samples of both variants: lines "
            + json.dumps(info["sample"]) + " identical with the torch engine "
            "and the serial oracle; accuracy bands of "
            "tests/test_accuracy_artifact.py held")
    return info


def write_annotations(db: str, rng) -> int:
    """``DB_annotations.txt`` with a gene of 600-2400 bases every
    ``TOOLS_GENE_STEP`` bases of every contig of ``db``, and the headerless
    ``DB_proteins.faa.annotated`` of ``tests/test_tools.py`` (protein,
    eggNOG, a class), both drawn from ``rng``. Returns the gene count."""
    n = 0
    with open(os.path.join(db, "DB_annotations.txt"), "w") as ann, \
            open(os.path.join(db, "DB_proteins.faa.annotated"), "w") as prot:
        ann.write("ContigId\tStart\tStop\tGeneName\tGeneLocusTag\t"
                  "CDSProteinId\tCDSProduct\n")
        for name, seq in read_sequences(os.path.join(db, "DB.fa")):
            for start in range(0, len(seq) - 2400, TOOLS_GENE_STEP):
                stop = start + int(rng.integers(600, 2401))
                ann.write(f"{name}\t{start}\t{stop}\tgene{n}\tLT{n}\tWP_{n}"
                          f"\tproduct {n}\n")
                prot.write(f"WP_{n}\teggNOG\tCOG{int(rng.integers(0, 500)):04d}"
                           "\n")
                n += 1
    return n


def write_proteins(path: str, rng) -> tuple:
    """A protein FASTA of ``TOOLS_PROTEINS`` records of 100-600 residues
    in lines of 60, drawn from ``rng``. Returns (records, residues)."""
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    residues = 0
    with open(path, "w") as f:
        for i in range(TOOLS_PROTEINS):
            seq = "M" + aa[rng.integers(0, 20, int(rng.integers(99, 600)))
                           ].tobytes().decode()
            residues += len(seq)
            f.write(f">WP_{i}.1 protein {i}\n")
            for j in range(0, len(seq), 60):
                f.write(seq[j:j + 60] + "\n")
    return TOOLS_PROTEINS, residues


def fasta_counts(path: str) -> tuple:
    """(records, residues) of a FASTA file."""
    records = residues = 0
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                records += 1
            else:
                residues += len(line.strip())
    return records, residues


def tools_phase(args, times: dict, card: str, db: str, out: str) -> dict:
    """The host tools users run on the card's output, through the port's
    CLI: geneLevelAnalysis and filterWIMP on phase 4's mapDirectly ->
    classify output, convertDB on its database, splitEggNog on a protein
    FASTA, evaluateExternal on phase 11's full-database run, and the plots
    where matplotlib is installed. Checks each output; returns each
    subcommand's seconds and the counts checked."""
    tdir = os.path.join(args.workdir, "tools")
    os.makedirs(tdir, exist_ok=True)
    rng = np.random.default_rng(args.seed + 12)
    seconds: dict = {}

    def run(name: str, argv: list) -> str:
        """One CLI command, timed under ``name``; returns its stdout."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        seconds[name] = time.perf_counter() - t0
        printed = buf.getvalue()
        log(f"{name}: {seconds[name]:.3f} s; " + " | ".join(
            line.strip() for line in printed.splitlines()[-3:]))
        if rc != 0:
            raise AssertionError(f"{name} exited with {rc}")
        return printed

    info: dict = {"card": card}
    with Phase("tools", times):
        info["genes"] = write_annotations(db, rng)
        printed = run("geneLevelAnalysis", ["geneLevelAnalysis", "--DB", db,
                                            "--mappings", out])
        n_with, n_without = (int(w) for w in printed.replace("(", " ").split()
                             if w.isdigit())
        n_em = sum(1 for _ in iter_reads_grouped(out + ".EM"))
        with open(out + ".EM.geneLevelAnalysis") as f:
            rows = [line.rstrip("\n").split("\t") for line in f][1:]
        bad = [r for r in rows if int(r[4]) < 1 or not 0 <= float(r[5]) <= 1]
        info["gene_level"] = dict(genes_hit=len(rows), reads_annotated=n_with,
                                  reads_not_annotated=n_without, reads_em=n_em)
        if not rows or bad:
            raise AssertionError(f"geneLevelAnalysis: {len(rows)} rows, "
                                 f"bad rows {bad[:3]}")
        if n_with + n_without != n_em:
            raise AssertionError(f"geneLevelAnalysis counted {n_with} + "
                                 f"{n_without} reads, .EM holds {n_em}")

        removed = {}
        for thr in ("0.8", "0.999"):
            printed = run(f"filterWIMP_{thr}", [
                "filterWIMP", "--DB", db, "--mappings", out,
                "--identityThreshold", thr])
            removed[thr] = int(printed.rsplit("(", 1)[1].split()[0])
            with open(out + ".EM.reads2Taxon.filteredByIdentity") as f:
                kept = sum(1 for line in f
                           if line.rstrip("\n").split("\t")[1] != "0")
            if thr == "0.999" and kept:
                raise AssertionError(f"filterWIMP 0.999 kept {kept} reads")
        info["filterWIMP_units_removed"] = removed

        contigs = [name for name, _ in read_sequences(os.path.join(db,
                                                                   "DB.fa"))]
        taxa = {extract_taxon_id(name) for name in contigs}
        for target in ("kraken", "centrifuge", "mash"):
            run(f"convertDB_{target}", [
                "convertDB", "--DB", db, "--to", target, "--output",
                os.path.join(tdir, target)])
        with open(os.path.join(tdir, "kraken", "library",
                               "metamaps.fna")) as f:
            heads = [line for line in f if line.startswith(">")]
        with open(os.path.join(tdir, "centrifuge", "seqid2taxid.map")) as f:
            n_map = sum(1 for _ in f)
        n_mash = len(os.listdir(os.path.join(tdir, "mash")))
        info["convertDB"] = dict(contigs=len(contigs), taxa=len(taxa),
                                 kraken_headers=len(heads),
                                 seqid2taxid_lines=n_map, mash_files=n_mash)
        if len(heads) != len(contigs) or not all("kraken:taxid|" in h
                                                 for h in heads):
            raise AssertionError("convertDB kraken: headers without their "
                                 "taxon")
        if n_map != len(contigs) or n_mash != len(taxa):
            raise AssertionError(f"convertDB: {n_map} seqid2taxid lines for "
                                 f"{len(contigs)} contigs, {n_mash} mash "
                                 f"files for {len(taxa)} taxa")

        prot = os.path.join(tdir, "proteins.faa")
        want = write_proteins(prot, rng)
        stand_in = os.path.join(tdir, "emapper_stand_in.py")
        with open(stand_in, "w") as f:
            f.write(FAKE_EMAPPER)
        annot = os.path.join(tdir, "annot.txt")
        eggnog = ["splitEggNog", "--input", prot, "--output", annot]
        run("splitEggNog_split", eggnog + ["--action", "split",
                                           "--targetChars",
                                           str(TOOLS_TARGET_CHARS)])
        run("splitEggNog_submit", eggnog + [
            "--action", "submit", "--cmd",
            f"{sys.executable} {stand_in} {{input}} {{output}}"])
        chunks = sorted(
            (n for n in os.listdir(tdir) if n.startswith("annot.txt.split.i.")),
            key=lambda n: int(n.rsplit(".", 1)[1]))
        t0 = time.perf_counter()
        for n in chunks:
            subprocess.run(["bash", os.path.join(
                tdir, "annot.txt.split.submit." + n.rsplit(".", 1)[1])],
                check=True, timeout=300)
        seconds["splitEggNog_jobs"] = time.perf_counter() - t0
        run("splitEggNog_collect", eggnog + ["--action", "collect"])
        got = [fasta_counts(os.path.join(tdir, n)) for n in chunks]
        got = tuple(sum(c) for c in zip(*got))
        with open(annot) as f:
            n_rows = sum(1 for _ in f) - 1
        info["splitEggNog"] = dict(chunks=len(chunks), records=got[0],
                                   residues=got[1], collected_rows=n_rows)
        if len(chunks) < 2 or got != want or n_rows != want[0]:
            raise AssertionError(f"splitEggNog: {len(chunks)} chunks hold "
                                 f"{got}, the input {want}; {n_rows} rows")

        root = os.path.join(args.workdir, "acc", "store", "acc")
        run_out = os.path.join(root, "runs", "full__metamaps", "out")
        truth = os.path.join(root, "reads.truth")
        with open(truth) as f:
            n_truth = sum(1 for line in f
                          if line.rstrip("\n").split("\t")[1] not in ("", "0"))
        evaluate = ["evaluateExternal", "--DB",
                    os.path.join(args.workdir, "acc", "DB"), "--truth", truth,
                    "--fastq", os.path.join(root, "reads.fastq"), "--method",
                    f"metamaps={run_out}.EM.reads2Taxon:{run_out}.EM.WIMP"]
        printed = run("evaluateExternal", evaluate + [
            "--output", os.path.join(tdir, "eval")])
        n_counted = int(printed.split()[0])
        with open(os.path.join(tdir, "eval.readLevel.tsv")) as f:
            acc = [float(line.rstrip("\n").split("\t")[8])
                   for line in list(f)[1:]]
        with open(os.path.join(tdir, "eval.distribution.tsv")) as f:
            n_dist = sum(1 for _ in f) - 1
        info["evaluateExternal"] = dict(
            truth_reads=n_truth, reads_counted=n_counted, read_rows=len(acc),
            distribution_rows=n_dist, accuracy_min=min(acc, default=None))
        if n_counted != n_truth or not acc or n_dist < 1 or not all(
                0 <= a <= 1 for a in acc):
            raise AssertionError("evaluateExternal: "
                                 + json.dumps(info["evaluateExternal"]))

        if importlib.util.find_spec("matplotlib") is None:
            info["plots"] = "not run: matplotlib is not installed"
            log("plots not run: matplotlib is not installed on this machine "
                "(plotIdentities, evaluateExternal --plots)")
        else:
            run("plotIdentities", ["plotIdentities", "--mappings", out,
                                   "--output",
                                   os.path.join(tdir, "identities.pdf")])
            run("evaluateExternal_plots", evaluate + [
                "--output", os.path.join(tdir, "plots"), "--plots"])
            info["plots"] = sorted(n for n in os.listdir(tdir)
                                   if n.endswith(".pdf"))
        pdfs = [n for n in os.listdir(tdir) if n.endswith(".pdf")]
        if isinstance(info["plots"], str) == bool(pdfs):
            raise AssertionError(f"PDFs {pdfs}: {info['plots']}")
        info["seconds"] = seconds
        log(f"tools ({card}): " + json.dumps(info))
    return info


def at_scale_phase(args, times: dict, card: str, counters, dev,
                   clock_mhz: float) -> tuple:
    """The repo's 1 Gbp run through the port's bench (phase 13): build and
    store the index once, map the 16,384 reads on the shard as built, the
    same pass at each bucket's own L1 hit capacity, the union, both EM
    rounds, ``mapAgainstIndex`` on the stored index (its one restore, held
    to the bench's lines), then the checks, the batch kernel against its
    plain version on the first 1 Gbp slab and, last and alone, the oracle
    sample. Returns (the run's numbers, the batch kernel's launches on the
    path, its max abs difference, its numbers per slab, and the union for
    phase 14: its lines, the reads and the database's bases)."""
    cache = os.path.join(args.workdir, "bench_cache")
    params = bench.bench_params()
    batch = l2_sweep.l2_event_sweep_batch
    info: dict = {"card": card, "bases": bench.LARGE_BASES,
                  "seed": bench.LARGE_SEED}
    with Phase("scale_index", times):
        shard, reads, build = bench.build_db_large(cache_dir=cache)
        if build.get("cache") != "miss":
            raise AssertionError(f"the 1 Gbp index was not built: {build}")
        info.update(build=build, minimizers=shard.n_minimizers,
                    freq_threshold=int(shard.freq_threshold),
                    index_bytes=os.path.getsize(
                        bench.cache_prefix(cache, bench.LARGE_BASES,
                                           bench.LARGE_SEED) + ".1.npz"))
        log(f"1 Gbp index built and stored: {json.dumps(info)}")
    prefix = bench.cache_prefix(cache, bench.LARGE_BASES, bench.LARGE_SEED)

    for fn in counters:
        fn.launches = 0
    l1._MINHITS.clear()  # the table as a fresh process computes it
    detail: dict = {}
    with Phase("scale_map", times):
        engine, results = bench.map_shard_bench(shard, reads, params, dev,
                                                detail)
    info["bench"] = detail
    log("1 Gbp bench " + json.dumps(detail))
    # the same pass at each bucket's own capacity: the reads the override
    # keeps from the serial oracle, and the same mappings either way
    with Phase("scale_default_cap", times):
        own = TorchMapperEngine(shard, params, device=dev,
                                read_len_buckets=bench.BENCH_BUCKETS,
                                tables=engine.tables)
        t0 = time.perf_counter()
        own_results = own.map_reads(reads)
        torch.cuda.synchronize()
        info["default_cap"] = dict(
            hits_max={b: own._config_for(b).hits_max
                      for b in bench.BENCH_BUCKETS},
            oracle_fallbacks=own.stats["oracle_fallbacks"],
            map_s=time.perf_counter() - t0)
        differ = [i for i, (a, b) in enumerate(zip(own_results, results))
                  if a != b and format_maps(a, shard, "r")
                  != format_maps(b, shard, "r")]
        if differ:
            raise AssertionError(f"at each bucket's own L1 hit capacity "
                                 f"the 1 Gbp mappings of {len(differ)} reads "
                                 f"differ from the bench's, read{differ[0]} "
                                 "first")
        del own, own_results
        log("1 Gbp pass at each bucket's own L1 hit capacity: "
            + json.dumps(info["default_cap"]))
    with Phase("scale_union", times):
        merged, n_mapped = bench.unify_lines(params, [results], [shard],
                                             len(reads))
    with Phase("scale_em", times):
        info["em_1M"] = bench.em_bench_synthetic(np.random.default_rng(7),
                                                 dev)
        info["em_realdist"] = bench.em_bench_realdist(merged, [shard], dev)
        log("1 Gbp EM: " + json.dumps({k: info[k] for k in
                                        ("em_1M", "em_realdist")}))
    mai_dir = os.path.join(args.workdir, "scale_mai")
    os.makedirs(mai_dir, exist_ok=True)
    mai_fq = os.path.join(mai_dir, "reads.fastq")
    mai_out = os.path.join(mai_dir, "out")
    write_fastq(mai_fq, reads[:SCALE_MAI_READS])
    mai_stats: dict = {}
    with Phase("scale_map_against_index", times):
        if cli_main(["mapAgainstIndex", "--index", prefix, "--query", mai_fq,
                     "--output", mai_out, "--all", "--mapping-engine",
                     "torch"], engine_stats=mai_stats) != 0:
            raise AssertionError("mapAgainstIndex on the 1 Gbp index failed")
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}

    with Phase("scale_checks", times):
        info.update(launches=launches, reads_mapped_union=n_mapped,
                    union_lines=len(merged),
                    restore=dict(load_s=mai_stats["shard_load_s"][0],
                                 by="mapAgainstIndex"),
                    map_against_index=dict(
                        reads=SCALE_MAI_READS,
                        seconds=times["scale_map_against_index"],
                        **mai_stats))
        if launches[batch.__name__] <= 0:
            raise AssertionError("the batch kernel never ran at 1 Gbp")
        if detail["oracle_fallbacks"] > 0.01 * len(reads):
            raise AssertionError(f"{detail['oracle_fallbacks']} oracle "
                                 f"fallbacks of {len(reads)} reads at 1 Gbp")
        if detail["n_mapped"] < 0.9 * len(reads) or n_mapped != \
                detail["n_mapped"]:
            raise AssertionError(f"{detail['n_mapped']} (union {n_mapped}) "
                                 f"of {len(reads)} reads mapped at 1 Gbp")
        # (each EM round raised already if it left the host's by > 1e-12)
        want = [line for line in merged
                if int(line.split(" ", 1)[0][4:]) < SCALE_MAI_READS]
        with open(mai_out) as f:
            got = f.read().splitlines()
        if got != want:
            raise AssertionError(
                f"mapAgainstIndex on the stored 1 Gbp index: {len(got)} "
                f"lines, {sum(a != b for a, b in zip(got, want))} differing "
                f"from the bench's union's {len(want)}")
        meta = read_meta(mai_out)
        if meta["TotalReads"] != SCALE_MAI_READS or meta["ReadsMapped"] != \
                len({line.split(" ", 1)[0] for line in want}):
            raise AssertionError(f"mapAgainstIndex .meta {meta}")
        log(f"mapAgainstIndex on the stored 1 Gbp index, {SCALE_MAI_READS} "
            f"reads: {len(got)} lines equal to the bench's union; "
            + json.dumps(info["map_against_index"]))

    # where the loop's time goes: a fresh engine on the same tables, its
    # phases timed by CUDA events
    with Phase("scale_breakdown", times):
        fresh = TorchMapperEngine(shard, params, device=dev,
                                  read_len_buckets=bench.BENCH_BUCKETS,
                                  tables=engine.tables, profile=True,
                                  hits_max=bench.HITS_MAX)
        t0 = time.perf_counter()
        fresh.map_reads(reads)
        info["mapping_phase_s"] = dict(fresh.stats["phase_s"],
                                       total=time.perf_counter() - t0)
        del fresh
        log("1 Gbp mapping phases (s, stream time): "
            + json.dumps(info["mapping_phase_s"]))

    with Phase("scale_kernel", times):
        ref = l2_sweep.l2_event_sweep_ref
        b0 = engine._bucket_of(len(reads[0]))
        chunk = [r for r in reads if engine._bucket_of(len(r)) == b0]
        setups = engine.l2_slab_setups(chunk[:engine.CHUNK])
        timed: dict = {}
        slabs = []
        for i, (st, sp) in enumerate(setups):
            arrs = [t.contiguous() for t in (st.meta, st.qrank, st.signinq,
                                             st.rows)]
            if i == 0:  # the plain version takes seconds a slab: once
                err = compare("1 Gbp slab 0", batch, ref, arrs, sp,
                              timed=timed)
            host = [a.cpu().numpy() for a in arrs[:3]]
            bound_ms, bound_by, _ = sweep_bench.sweep_bound(
                *host, clock_mhz, sp=sp)
            inc, rec = sweep_bench.sweep_routes(*host, sp)
            slabs.append(dict(
                shape=[int(arrs[1].shape[0]), int(arrs[1].shape[1]), sp],
                ms=sweep_bench.time_ms(lambda: batch(*arrs, sp), dev, 5),
                bound_ms=bound_ms, bound_by=bound_by,
                incremental_events=int(inc.sum()),
                recount_events=int(rec.sum())))
        info["kernel"] = dict(bucket=b0, slabs=slabs, max_abs_err=err,
                              plain_ms_slab0=timed["plain_ms"])
        log("batch kernel on the first 1 Gbp chunk: " + json.dumps(
            info["kernel"]))

    # the serial oracle on the sample, after every timed step: workers
    # forked from this process read its shard, none loads one
    with Phase("scale_oracle_sample", times):
        _worker_state.update(shard=shard, params=params)
        with multiprocessing.get_context("fork").Pool(
                SCALE_ORACLE_WORKERS) as pool:
            _POOLS.append(pool)
            oracle_maps = pool.map(_oracle_map, reads[:SAMPLE], chunksize=1)
        _worker_state.clear()
        n_lines = 0
        for i, maps in enumerate(oracle_maps):
            want = format_maps(maps, shard, f"read{i}")
            if format_maps(results[i], shard, f"read{i}") != want:
                raise AssertionError(f"read{i} at 1 Gbp: the device engine "
                                     "and the serial oracle differ")
            n_lines += len(want)
        info["sample_lines"] = n_lines
        log(f"{SAMPLE}-read sample at 1 Gbp: {n_lines} mapping lines "
            f"identical on the device engine and the serial oracle "
            f"({SCALE_ORACLE_WORKERS} forked workers)")
    union = (merged, reads, detail["db_bases"])
    del engine, shard, results, merged, reads
    gc.collect()
    shutil.rmtree(cache, ignore_errors=True)
    return info, launches[batch.__name__], err, info["kernel"], union


def u_at_scale_phase(args, times: dict, card: str, union) -> dict:
    """The novel-species chain on phase 13's mappings (phase 14), through
    ``profiling/u_at_scale.py``'s ``main``: the union dumped with its
    sidecars, the database directory around the re-synthesised 1 Gbp
    genomes, then ``classify`` on the card (and on the host, compared),
    ``selfSimilarity`` on the ``U_SCALE_JOBS`` jobs with the fewest B
    bases in as many worker processes, ``collect`` and ``classifyU``; then
    the checks. Returns the chain's numbers."""
    merged, reads, db_bases = union
    n_reads = len(reads)
    work = os.path.join(args.workdir, "u_at_scale")
    os.makedirs(work, exist_ok=True)
    mappings = os.path.join(work, "bench_mappings_16k.txt")
    db = os.path.join(work, "u_db")
    with Phase("u_inputs", times):
        bench.dump_mappings(mappings, merged, reads, bench.bench_params(),
                            db_bases)
        _, genomes, names = bench.synth_genomes(bench.LARGE_BASES,
                                                bench.LARGE_SEED)
        u_at_scale.build_db_dir(db, genomes, names)
        del genomes
        jobs = ss.prepare(db, os.path.join(db, "selfSimilarity"))
        todo = u_at_scale.fewest_b_jobs(db, jobs, U_SCALE_JOBS)
    record = os.path.join(work, "record.json")
    with Phase("u_chain", times):
        rc = u_at_scale.main([
            "--mappings", mappings, "--db-dir", db, "--jobs",
            ",".join(map(str, todo)), "--workers", str(U_SCALE_JOBS),
            "--no-split", "--out", record])
        with open(record) as f:
            rec = json.load(f)
    with Phase("u_checks", times):
        failures = list(rec["selfsim_check_failures"])
        if rc != 0:
            failures.append(f"u_at_scale.main exited {rc}")
        differ = [k for k, same in rec["em_equal_numpy"].items() if not same]
        if differ:
            failures.append(f"{differ}: EM on the card and on the host "
                            "wrote different bytes")
        if rec["selfsim_jobs_run"] != todo:
            failures.append(f"jobs {rec['selfsim_jobs_run']} ran, {todo} "
                            "asked")
        if rec["u_reads2taxon_rows"] != n_reads:
            failures.append(f"{rec['u_reads2taxon_rows']} .U.reads2Taxon "
                            f"rows for {n_reads} reads")
        if rec["u_wimp_rows"] <= 0:
            failures.append(".U.WIMP is empty")
        # identities below --pi 80 are the reference's: a chunk maps where
        # its identity's upper bound reaches 80 (engine/mapper_oracle.py)
        with open(os.path.join(db, "selfSimilarities.txt")) as f:
            rows = [line.split("\t")[1:3] for line in f]
        idents = {int(i) for _, i in rows}
        bad = sorted({(int(n), int(i)) for n, i in rows if not
                      u_at_scale.identity_floor(int(n)) <= int(i) <= 100})
        if not rows:
            failures.append("selfSimilarities.txt is empty")
        if bad:
            failures.append(f"selfSimilarities.txt (length, identity) {bad} "
                            "outside [identity_floor, 100]")
        if failures:
            raise AssertionError("the U chain at 1 Gbp: "
                                 + "; ".join(failures))
        info = {k: rec[k] for k in (
            "classify_s", "classify_numpy_s", "selfsim_jobs_run",
            "selfsim_job_s", "selfsim_job_peak_rss_bytes",
            "selfsim_job_peak_rss_before_bytes", "selfsim_total_s",
            "selfsim_lines", "classifyU_s", "em_wimp_rows", "u_wimp_rows",
            "u_reads2taxon_rows")}
        info.update(card=card, selfsim_job_b_bases=[
            rec["selfsim_job_b_bases"][i] for i in todo],
            selfsim_identities=[min(idents), max(idents)])
        log(f"U chain at 1 Gbp ({card}): .EM* equal on the card and the "
            f"host, {n_reads} .U.reads2Taxon rows, {rec['u_wimp_rows']} "
            f".U.WIMP rows; " + json.dumps(info))
    shutil.rmtree(work, ignore_errors=True)
    return info


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
                l2_sweep.l2_event_sweep_wide, sketch)

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
        table_bytes = engine.tables.nbytes()
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
            plain: dict = {}  # batch and rb share the width sp
            for fn, width in sweeps:
                errs[fn.__name__].append(compare(
                    f"main-path slab {i}", fn, ref, arrs, width(sp),
                    plain=plain))
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
        # the sketch kernel on the same chunk as the engine uploads it, then
        # at the benchmark's chunk shapes
        cfg0 = engine._config_for(b0)
        first = chunk[: engine.CHUNK]
        reads0 = np.full((len(first), cfg0.read_len_max), ord("A"), np.uint8)
        for r, seq in enumerate(first):
            reads0[r, :len(seq)] = seq
        sketch_row = sketch_entry(
            "the main path's first chunk", reads0,
            np.array([len(seq) for seq in first], np.int64), cfg0.kmer_size,
            cfg0.window_size, cfg0.sketch_max, cfg0.alphabet_size, dev,
            clock_mhz)
        sketch_rng = np.random.default_rng(args.seed + 18)
        sketch_row["by_shape"] = [
            sketch_entry(name, *sketch_chunk(sketch_rng, B, bucket, lo, hi),
                         16, 16, MapConfig.for_read_len(bucket, 16,
                                                        16).sketch_max,
                         4, dev, clock_mhz)
            for name, B, bucket, lo, hi in SKETCH_SHAPES]

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
    sketch_launches = sketch.launches
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

        n_lines = 0
        for i in range(len(sample)):
            want = format_maps(oracle_maps[i], shard, f"read{i}")
            got = format_maps(dev_maps[i], shard, f"read{i}")
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
            scale=em_bench.run(dev, reps=3, log=lambda m: log(f"em_bench {m}"),
                               sharded_ranks=EM_SHARDED_RANKS))
        log("EM: 7 .EM* files identical on the card and the host; two "
            "rounds on the card identical in bits; " + json.dumps(em_stats))

    # ---- where the mapping time goes: a fresh engine on the uploaded
    # tables, as mapDirectly builds one, its phases timed by CUDA events
    with Phase("breakdown", times):
        fresh = TorchMapperEngine(shard, params, device=dev,
                                  tables=engine.tables, profile=True)
        t0 = time.perf_counter()
        fresh.map_reads(reads)
        breakdown = dict(fresh.stats["phase_s"],
                         total=time.perf_counter() - t0)
        log("mapping phases (s, stream time): " + json.dumps(breakdown))
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

    # ---- 10. the mesh: eight ranks of the card over four contig blocks -----
    mesh = mesh_phase(args, times, db, fq, reads, shard, params, out, card,
                      counters, dev)
    mesh.update(mesh_cli_and_em(long_run, times, db,
                                os.path.join(args.workdir, "mesh", "out"),
                                counters, dev))
    mesh_batch = mesh["launches"][l2_sweep.l2_event_sweep_batch.__name__]
    cli_batch = mesh["cli_launches"][l2_sweep.l2_event_sweep_batch.__name__]
    cli_wide = mesh["cli_launches"][l2_sweep.l2_event_sweep_wide.__name__]

    # ---- 11. ACCURACY.json's experiment on the card -----------------------
    acc = experiments_phase(args, times, card, counters)
    batch_name = l2_sweep.l2_event_sweep_batch.__name__
    wide_name = l2_sweep.l2_event_sweep_wide.__name__
    acc_batch, acc_wide = acc["launches"][batch_name], acc["launches"][wide_name]
    pi75 = long_info["pi75"]["launches"]
    batch_row.update(launches=(launches + mai["sweep_launches"] + lr_batch
                               + pi75[batch_name] + mesh_batch + cli_batch
                               + acc_batch),
                     launches_mapDirectly=launches,
                     launches_mapAgainstIndex=mai["sweep_launches"],
                     launches_long_read=lr_batch,
                     launches_long_read_pi75=pi75[batch_name],
                     launches_mesh=mesh_batch, launches_mesh_cli=cli_batch,
                     launches_experiments=acc_batch)
    wide_row.update(launches=(wide_row["launches"] + pi75[wide_name]
                              + cli_wide + acc_wide),
                    launches_long_read=wide_row["launches"],
                    launches_long_read_pi75=pi75[wide_name],
                    launches_mesh_cli=cli_wide, launches_experiments=acc_wide)
    sketch_by_phase = dict(
        mapDirectly=sketch_launches, mapAgainstIndex=mai["sketch_launches"],
        long_read=long_info["launches"][sketch.__name__],
        long_read_pi75=pi75[sketch.__name__],
        mesh=mesh["launches"][sketch.__name__],
        mesh_cli=mesh["cli_launches"][sketch.__name__],
        experiments=acc["launches"][sketch.__name__])

    # ---- 12. the host tools on the card's outputs --------------------------
    tools = tools_phase(args, times, card, db, out)

    # ---- 13. the 1 Gbp run ------------------------------------------------
    scale, scale_batch, scale_err, scale_kernel, union = at_scale_phase(
        args, times, card, counters, dev, clock_mhz)
    sketch_by_phase["at_scale"] = scale["launches"][sketch.__name__]
    log(f"sketch kernel launches by phase: {json.dumps(sketch_by_phase)}")
    for phase in ("mapDirectly", "mapAgainstIndex", "mesh", "at_scale"):
        if sketch_by_phase[phase] <= 0:
            raise AssertionError(f"the sketch kernel never ran in {phase}")
    sketch_row.update(launches=sum(sketch_by_phase.values()),
                      **{f"launches_{k}": v
                         for k, v in sketch_by_phase.items()})
    batch_row.update(launches=batch_row["launches"] + scale_batch,
                     launches_at_scale=scale_batch,
                     max_abs_err=max(batch_row["max_abs_err"], scale_err),
                     at_scale_ms_by_slab=[r["ms"] for r in
                                          scale_kernel["slabs"]],
                     at_scale_bound_ms_by_slab=[r["bound_ms"] for r in
                                                scale_kernel["slabs"]],
                     at_scale_plain_ms_slab0=scale_kernel["plain_ms_slab0"])

    # ---- 14. the U chain on the 1 Gbp run's mappings ----------------------
    u_scale = u_at_scale_phase(args, times, card, union)
    del union

    # ---- 15. summary ------------------------------------------------------
    map_s = engine_stats["map_s"]
    summary = {
        "reads": len(reads), "reads_mappable": mappable,
        "reads_mapped": meta["ReadsMapped"],
        "mapping_reads_per_s": mappable / map_s,
        "mapDirectly_s": times["mapDirectly"], "mapping_s": map_s,
        "minhits_s": engine_stats["minhits_s"],
        "classify_s": times["classify"], "em": em_stats,
        "index_minimizers": shard.n_minimizers,
        "peak_device_bytes": peak, "device_table_bytes": table_bytes,
        "oracle_fallbacks": fallbacks,
        "l2_candidates": engine_stats["l2_candidates"],
        "sweep_launches": launches, "phase_s": times,
        "mapping_phase_s": breakdown, "sweep_bench_ms": scenario_ms,
        "sm_clock_max_mhz": clock_mhz, "map_against_index": mai,
        "long_read": long_info, "mesh": mesh, "experiments": acc,
        "tools": tools, "at_scale": scale, "u_at_scale": u_scale,
        "card": card,
    }
    log("summary " + json.dumps(summary))
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [batch_row] + variant_rows
                      + [wide_row, sketch_row]}))
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
