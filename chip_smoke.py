#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``metamaps_tpu_torch``) on one
NVIDIA card: builds the L2 sweep kernel from ``metamaps_tpu_torch/csrc``,
holds it against its plain PyTorch version, then drives the port's main
path -- ``mapDirectly`` followed by ``classify`` through the port's CLI --
on a mock-community-scale synthetic database, and checks the outputs.

    python3 chip_smoke.py                  # 36 genomes x 3 Mbp, 4096 reads
    python3 chip_smoke.py --reads 512 --genome-len 1000000

Phases (each prints its wall seconds; any failure exits non-zero):

1. environment: torch / CUDA versions and the card; no card, no run;
2. build: nvcc for sm_90a into build/metamaps_tpu_torch/;
3. kernel vs plain on the card, bit for bit: the real L2 event streams of
   the first read chunk, and random contract-conforming streams with plane
   widths below and above 48 KB of shared memory; CUDA-event timings;
4. main path: synthetic DB (write_synth_db_dir) + ONT-like reads, then the
   port's ``mapDirectly`` (torch engine on CUDA) and ``classify``;
5. checks: the kernel ran on the main path, oracle fallbacks <= 1% of
   mappable reads, a 64-read sample gives byte-identical mapping lines on
   the device engine and the serial oracle, .meta counts add up, >= 90% of
   reads mapped, EM outputs written;
6. breakdown: a fresh engine on the uploaded tables maps the reads once
   more with a synchronise after each phase, and prints each phase's
   seconds;
7. summary: reads/s, classify seconds, peak device memory, then the card
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

from metamaps_tpu.io.fasta import read_sequences
from metamaps_tpu.io.mappings import MappingLine, read_meta
from metamaps_tpu.io.native import winnow_native
from metamaps_tpu.sim.synth_db import ont_read, write_synth_db_dir
from metamaps_tpu_torch.cli import main as cli_main
from metamaps_tpu_torch.engine import mapper_oracle
from metamaps_tpu_torch.engine.index import SketchShard, build_shards
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.ops import l2_sweep

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 64  # reads checked line by line against the serial oracle

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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_sweep(label, arrs, sp, dev, time_it=False):
    """Kernel vs plain version on the card; returns (max_abs_err, ms,
    plain_ms). Exact int32 arithmetic: any difference fails."""
    arrs = [a.to(dev).contiguous() for a in arrs]
    got = l2_sweep.l2_event_sweep(*arrs, sp)
    torch.cuda.synchronize()
    want = l2_sweep.l2_event_sweep_ref(*arrs, sp)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    n, e2 = arrs[1].shape
    ms = plain_ms = None
    if time_it:
        ms = cuda_ms(lambda: l2_sweep.l2_event_sweep(*arrs, sp), 5)
        plain_ms = cuda_ms(lambda: l2_sweep.l2_event_sweep_ref(*arrs, sp), 1)
    log(f"sweep {label}: N={n} E2={e2} sp={sp} max_abs_err={err}"
        + (f" kernel {ms:.3f} ms plain {plain_ms:.3f} ms" if time_it else ""))
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"sweep kernel differs from plain on {label}")
    return err, ms, plain_ms


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

    # ---- 1. environment --------------------------------------------------
    with Phase("environment", times):
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this "
                               "smoke test runs on an NVIDIA card only")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        log(f"card: {card}; torch sees {torch.cuda.device_count()} device(s): "
            f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build ---------------------------------------------------------
    with Phase("build", times):
        l2_sweep.load_library()
        info = l2_sweep.build_info
        log(f"kernel library {info.get('library')} built in "
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
        from metamaps_tpu.cli import _add_sketch_args, _sketch_params

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
        st, sp = setups[0]
        err, ms, plain_ms = compare_sweep(
            "main-path slab", (st.meta, st.qrank, st.signinq, st.rows), sp,
            dev, time_it=True)
        errs = [err]
        for st_i, sp_i in setups[1:]:
            errs.append(compare_sweep(
                "main-path slab", (st_i.meta, st_i.qrank, st_i.signinq,
                                   st_i.rows), sp_i, dev)[0])
        for sp_r, e2 in ((1152, 900), (10240, 400)):  # 9 KB and 80 KB planes
            arrs = l2_sweep.random_event_streams(
                np.random.default_rng(sp_r), 257, e2, sp_r - 1)
            errs.append(compare_sweep(
                f"random sp={sp_r}", [torch.from_numpy(a) for a in arrs],
                sp_r, dev)[0])
        kernel_row = {"name": "l2_event_sweep", "route": "cuda",
                      "source": "metamaps_tpu_torch/csrc/l2_sweep.cu",
                      "replaces": "metamaps_tpu/ops/l2_pallas.py:116",
                      "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                      "shape": [int(st.rows.shape[0]), int(st.rows.shape[1]), sp]}

    # ---- 4. main path -----------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    l2_sweep.l2_event_sweep.launches = 0
    engine_stats: dict = {}
    with Phase("mapDirectly", times):
        if cli_main(argv_map, engine_stats=engine_stats) != 0:
            raise AssertionError("mapDirectly failed")
        torch.cuda.synchronize()
    with Phase("classify", times):
        if cli_main(["classify", "--DB", db, "--mappings", out]) != 0:
            raise AssertionError("classify failed")
    launches = l2_sweep.l2_event_sweep.launches
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
        for suffix in (".EM.WIMP", ".EM.reads2Taxon"):
            if os.path.getsize(out + suffix) == 0:
                raise AssertionError(f"{suffix} is empty")
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

    # ---- 6. summary -------------------------------------------------------
    map_s = engine_stats["map_s"]
    summary = {
        "reads": len(reads), "reads_mappable": mappable,
        "reads_mapped": meta["ReadsMapped"],
        "mapping_reads_per_s": mappable / map_s,
        "mapDirectly_s": times["mapDirectly"], "mapping_s": map_s,
        "classify_s": times["classify"], "index_minimizers": shard.n_minimizers,
        "peak_device_bytes": peak, "oracle_fallbacks": fallbacks,
        "l2_candidates": engine_stats["l2_candidates"],
        "sweep_launches": launches, "phase_s": times,
        "mapping_phase_s": breakdown,
    }
    log("summary " + json.dumps(summary))
    kernel_row["launches"] = launches
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [kernel_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
