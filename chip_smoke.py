#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``metamaps_tpu_torch``) on one
NVIDIA card: builds the L2 sweep kernels from ``metamaps_tpu_torch/csrc``,
holds each against its plain PyTorch version, drives the port's main path
-- ``mapDirectly`` followed by ``classify`` (EM rounds on the card) through
the port's CLI -- on a mock-community-scale synthetic database, checks the
outputs, then drives the sweep bench, the path of the other sweep kernels.

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
8. summary: reads/s, classify seconds, peak device memory, then the card
   line, the kernel JSON line and the final JSON line.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from metamaps_tpu_torch.cli import _add_sketch_args, _sketch_params
from metamaps_tpu_torch.cli import main as cli_main
from metamaps_tpu_torch.engine import em, mapper_oracle
from metamaps_tpu_torch.engine.index import SketchShard, build_shards
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.io.fasta import read_sequences
from metamaps_tpu_torch.io.mappings import MappingLine, read_meta
from metamaps_tpu_torch.io.native import winnow_native
from metamaps_tpu_torch.ops import l2_sweep, l2_sweep_parts
from metamaps_tpu_torch.profiling import em_bench, sweep_bench
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

# the serial oracle takes seconds per read at this database size, so the
# sample is mapped by a pool of spawned workers that load the shard from disk
_worker_state: dict = {}


def _oracle_worker_init(shard_path: str, params) -> None:
    _worker_state["shard"] = SketchShard.load(shard_path)
    _worker_state["params"] = params


def _oracle_map(seq):
    return mapper_oracle.map_read(_worker_state["shard"],
                                  _worker_state["params"], seq)


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


def compare(label, fn, ref, arrs, *width):
    """A kernel wrapper ``fn`` against its plain version ``ref`` on the same
    CUDA tensors; returns the max abs difference. Exact int32 arithmetic:
    any difference fails."""
    got = fn(*arrs, *width)
    torch.cuda.synchronize()
    want = ref(*arrs, *width)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    n, e2 = arrs[1].shape
    log(f"{fn.__name__} vs plain, {label}: N={n} E2={e2} "
        f"width={list(width)} max_abs_err={err}")
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{fn.__name__} differs from plain on {label}")
    return err


def kernel_entry(name, source, replaces, arrs, width, clock_mhz, err, fn,
                 ref, sp=None, bound=None, **extra):
    """One row of the kernels line: the kernel's and the plain version's
    CUDA-event times on ``arrs`` and the bound on the same inputs, from the
    work this data needs: ``bound`` (ms, bound_by, counts) where given,
    else ``sweep_bench.sweep_bound`` with ``sp``, and then the row also
    carries the bound with every event recounted and the events in each
    mode."""
    ms = sweep_bench.time_ms(lambda: fn(*arrs, *width), arrs[0].device, 5)
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


def write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            s = seq.tobytes().decode()
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


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
                l2_sweep.l2_event_sweep, l2_sweep_parts.l2_sweep_parts)

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

    argv_map = ["mapDirectly", "--reference", os.path.join(db, "DB.fa"),
                "--query", fq, "--output", out, "--all",
                "--mapping-engine", "torch"]
    with Phase("index", times):
        p = argparse.ArgumentParser()
        _add_sketch_args(p)
        params = _sketch_params(p.parse_known_args(argv_map[1:])[0])
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
        for fn in counters[1:]:
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
        batch_row["launches"] = launches
        scenario_ms = {row["scenario"]: row["ms"] for row in bench["scenarios"]}
        log("sweep bench ms by scenario: " + json.dumps(scenario_ms))

    # ---- 8. summary -------------------------------------------------------
    map_s = engine_stats["map_s"]
    summary = {
        "reads": len(reads), "reads_mappable": mappable,
        "reads_mapped": meta["ReadsMapped"],
        "mapping_reads_per_s": mappable / map_s,
        "mapDirectly_s": times["mapDirectly"], "mapping_s": map_s,
        "classify_s": times["classify"], "em": em_stats,
        "index_minimizers": shard.n_minimizers,
        "peak_device_bytes": peak, "oracle_fallbacks": fallbacks,
        "l2_candidates": engine_stats["l2_candidates"],
        "sweep_launches": launches, "phase_s": times,
        "mapping_phase_s": breakdown, "sweep_bench_ms": scenario_ms,
        "sm_clock_max_mhz": clock_mhz,
    }
    log("summary " + json.dumps(summary))
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [batch_row] + variant_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
