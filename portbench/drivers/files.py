"""Driver of file traffic: one lab streams its sequencer's FASTQ files
against a resident shard, back to back (a closed loop).

Set-up draws the pool of files from the seed and writes them, builds the
shard and the engine as the CLI does (threaded winnowing,
``SketchShard.finalize``, ``TorchMapperEngine`` with its default buckets
and hit capacity) and maps the first files of the pool to warm every
shape. The window maps file after file with the program's own calls for
one shard, ``map_query_file_against_shard`` then ``unify_query_file``,
until ``--seconds`` have passed; the window ends when the last file ends.
"""
from __future__ import annotations

import gc
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import core
from portbench.frozen.synth_db import ont_read
from portbench.frozen.sweep_bound import SM_CLOCK_MHZ, sweep_bound
from portbench.reference import mapping as reference

def _params(cfg: dict, reference_size: int):
    from metamaps_tpu_torch.params import Parameters

    return Parameters(reference_size=reference_size, **cfg["params"])


def draw_pool(mix: dict, genomes, shares, seed: int):
    """The pool's reads, ``pool_files`` lists of ``reads_per_file`` reads.
    Every seed gets the same multiset of (genome, length) pairs, drawn from
    ``length_seed`` with genome ``i`` at ``shares[i]``, in its own order and
    at positions of its own."""
    n = int(mix["pool_files"]) * int(mix["reads_per_file"])
    fixed = np.random.default_rng(mix["length_seed"])
    lengths = fixed.integers(mix["read_min"], mix["read_max"], n)
    source = fixed.choice(len(genomes), n, p=shares)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    reads = [ont_read(rng, genomes[int(source[i])], int(lengths[i]), mix["sub"],
                      mix["ins"], mix["del"])[:int(mix["read_cut"])]
             for i in order]
    per = int(mix["reads_per_file"])
    return [reads[i:i + per] for i in range(0, n, per)]


def read_name(j: int, r: int) -> str:
    return f"f{j}r{r}"


def write_fastq(path, reads, j: int) -> None:
    with open(path, "w") as f:
        for r, seq in enumerate(reads):
            s = seq.tobytes().decode()
            f.write(f"@{read_name(j, r)}\n{s}\n+\n{'I' * len(s)}\n")


def build_engine(ctx, genomes, names, params):
    """The shard (winnowing on a thread pool, then ``finalize``) and the
    engine over it, whose construction uploads the tables."""
    from metamaps_tpu_torch.engine.index import SketchShard
    from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
    from metamaps_tpu_torch.ops.winnow import winnow_fast

    k, w = params.kmer_size, params.window_size
    with ThreadPoolExecutor(core.HOST_THREADS) as ex:
        outs = list(ex.map(lambda g: winnow_fast(g, k, w), genomes))
    shard = SketchShard()
    parts = []
    for i, (g, (h, p, s)) in enumerate(zip(genomes, outs)):
        parts.append((h, p, s, i))
        shard.contig_names.append(names[i])
        shard.contig_lengths.append(len(g))
    del outs
    shard.finalize(parts)
    del parts
    engine = TorchMapperEngine(shard, params, device=ctx.device,
                               profile=ctx.trace)
    if ctx.on_card:
        torch.cuda.synchronize(ctx.device)
    return shard, engine


def setup(ctx, setup_mod) -> dict:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    with ctx.span("synth"):
        genomes, names = setup_mod.genomes(cfg)
    params = _params(cfg, sum(len(g) for g in genomes))
    with ctx.span("reads"):
        pool = draw_pool(mix, genomes, setup_mod.read_shares(cfg), ctx.seed)
        fastq = []
        for j, reads in enumerate(pool):
            fastq.append(str(ctx.workdir / f"pool{j}.fastq"))
            write_fastq(fastq[-1], reads, j)
    with ctx.span("index.build"):
        shard, engine = build_engine(ctx, genomes, names, params)
    core.log(f"shard: {shard.n_minimizers} minimizers, frequency threshold "
             f"{shard.freq_threshold}; index {ctx.span_s('index.build'):.2f} s")
    mappable = [sum(len(s) >= max(params.window_size, params.kmer_size,
                                  params.min_read_length) for s in reads)
                for reads in pool]
    st = dict(genomes=genomes, names=names, params=params, pool=pool,
              fastq=fastq, mappable=mappable, shard=shard, engine=engine,
              buckets=tuple(engine.buckets), outdir=ctx.workdir / "out", n=0)
    os.makedirs(st["outdir"], exist_ok=True)
    with ctx.span("warm"):
        for _ in range(int(mix["warm_files"])):
            one_file(ctx, st)
    core.log("set-up parts: " + ", ".join(
        f"{n} {ctx.span_s(n):.2f} s" for n in ("synth", "reads", "index.build", "warm")))
    return st


def one_file(ctx, st) -> dict:
    """Map and unify the next file of the pool; its record."""
    from metamaps_tpu_torch.engine.mapwrap import (
        STAT_KEYS, map_query_file_against_shard, unify_query_file)

    it = st["n"]
    st["n"] += 1
    j = it % len(st["fastq"])
    eng = st["engine"]
    prefix = str(st["outdir"] / f"file{it}")
    ph0 = dict(eng.stats["phase_s"])
    c0 = {k: eng.stats[k] for k in STAT_KEYS}
    t0 = time.perf_counter()
    with core.record_function("map"):
        map_query_file_against_shard(st["shard"], st["params"], st["fastq"][j],
                                     prefix + ".0", mapper=eng)
    t1 = time.perf_counter()
    with core.record_function("unify"):
        unify_query_file(prefix, st["fastq"][j], st["params"], [prefix + ".0"])
    t2 = time.perf_counter()
    ph = {k: v - ph0.get(k, 0.0) for k, v in eng.stats["phase_s"].items()}
    return dict(it=it, j=j, prefix=prefix, t0=t0, t1=t1, t2=t2,
                reads=st["mappable"][j], phase_s=ph,
                **{k: eng.stats[k] - c0[k] for k in STAT_KEYS})


def window(ctx, st) -> None:
    st["n"] = 0  # the window starts at the pool's first file again
    files = []
    t0 = time.perf_counter()
    while not files or time.perf_counter() - t0 < ctx.seconds:
        files.append(one_file(ctx, st))
    ctx.record["window_s"] = files[-1]["t2"] - t0
    ctx.record["files"] = files
    core.log(f"window: {len(files)} files in {ctx.record['window_s']:.2f} s")


def traced(ctx, st) -> None:
    """After the window: ``trace_files`` more files under the profiler,
    with the engine's per-phase synchronise off, and the L2 sweeps' bound
    on the same files' slabs beside their kernel time."""
    mix = ctx.cell.traffic
    eng = st["engine"]
    eng.profile = False
    with core.profiled(ctx, "trace"):
        traced_files = [one_file(ctx, st) for _ in range(int(mix["trace_files"]))]
    eng.profile = True
    ctx.record["traced_files"] = traced_files
    if ctx.on_card:
        sw = ctx.record["sweep"] = _sweep_roofline(ctx, st, traced_files)
        core.log(f"L2 sweeps: bound {sw['bound_ms']:.4f} ms, kernels "
                 f"{sw['kernel_ms']:.4f} ms ({sw['source']}, {sw['slabs']} "
                 f"slabs) on {core.card_and_power_limit()}")


def _sweep_roofline(ctx, st, files) -> dict:
    """Σ bound (frozen ``sweep_bound`` on the slabs the engine builds for
    these files' reads) and Σ device time of the sweep kernels: from the
    trace where it names them, else from CUDA events over a replay of the
    same slabs."""
    from metamaps_tpu_torch.ops.l2_sweep import l2_event_sweep_batch

    eng = st["engine"]
    setups = []
    for rec in files:
        by_bucket = {}
        for seq in st["pool"][rec["j"]]:
            b = next((b for b in eng.buckets if len(seq) <= b), None)
            by_bucket.setdefault(b, []).append(seq)
        for seqs in by_bucket.values():
            for c in range(0, len(seqs), eng.CHUNK):
                setups += eng.l2_slab_setups(seqs[c:c + eng.CHUNK])
    bound_ms = sum(sweep_bound(s.meta.cpu().numpy(), s.qrank.cpu().numpy(),
                               s.signinq.cpu().numpy(), SM_CLOCK_MHZ,
                               sp=sp)[0] for s, sp in setups)
    tr = ctx.record.get("trace") or {}
    traced_ms = 1e3 * sum(v for k, v in tr.get("by_op", {}).items()
                          if "sweep" in k.lower())
    if traced_ms > 0:
        return dict(bound_ms=bound_ms, kernel_ms=traced_ms, source="trace",
                    slabs=len(setups))
    kernel_ms = 0.0
    for s, sp in setups:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        l2_event_sweep_batch(s.meta, s.qrank, s.signinq, s.rows, sp)
        b.record()
        torch.cuda.synchronize(ctx.device)
        kernel_ms += a.elapsed_time(b)
    return dict(bound_ms=bound_ms, kernel_ms=kernel_ms, source="events",
                slabs=len(setups))


def counts(ctx, st):
    """(attempted, failed) files of the window: a file fails when its
    ``.meta`` does not account for every read of the file."""
    files = ctx.record["files"]
    failed = 0
    for rec in files:
        meta = {}
        try:
            with open(rec["prefix"] + ".meta") as f:
                for line in f:
                    key, _, val = line.partition(" ")
                    meta[key] = int(val)
        except (OSError, ValueError):
            failed += 1
            continue
        n = len(st["pool"][rec["j"]])
        if (meta.get("TotalReads") != n or meta.get("ReadsTooShort", 0)
                + meta.get("ReadsMapped", 0) + meta.get("ReadsNotMapped", 0) != n):
            failed += 1
    return len(files), failed


def _free_program(ctx, st) -> None:
    st.pop("engine", None)
    st.pop("shard", None)
    gc.collect()
    if ctx.on_card:
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()


def sample(ctx, st, files, lines_of=None):
    """(file record, read index) pairs to check, drawn from the seed over
    every read of the timed files: ``sample_reads`` spread evenly over the
    engine's length buckets, up to ``sample_odd_reads`` of the reads to
    which ``lines_of`` (the program's lines per read) gives no line or
    more than one, and the longest read."""
    mix = ctx.cell.traffic
    rng = np.random.default_rng([ctx.seed, 7])
    every = [(fi, r) for fi, rec in enumerate(files)
             for r in range(len(st["pool"][rec["j"]]))]
    length = {fr: len(st["pool"][files[fr[0]]["j"]][fr[1]]) for fr in every}
    by_bucket = {}
    for fr in every:
        b = next((b for b in st["buckets"] if length[fr] <= b), None)
        by_bucket.setdefault(b, []).append(fr)
    quota = -(-int(mix["sample_reads"]) // len(by_bucket))
    pairs = set()
    for b in sorted(by_bucket, key=lambda b: (b is None, b)):
        got = by_bucket[b]
        for i in rng.choice(len(got), min(quota, len(got)), replace=False):
            pairs.add(got[int(i)])
    if lines_of is not None:
        odd = [fr for fr in every if lines_of(fr) != 1]
        for i in rng.choice(len(odd), min(int(mix["sample_odd_reads"]), len(odd)),
                            replace=False):
            pairs.add(odd[int(i)])
    pairs.add(max(every, key=lambda fr: length[fr]))
    return sorted(pairs)


def program_lines(prefix: str) -> dict:
    """Read name -> the lines the program's unified output holds for it."""
    out = {}
    with open(prefix) as f:
        for line in f:
            out.setdefault(line.split(" ", 1)[0], []).append(line.rstrip("\n"))
    return out


def reference_lines(ctx, st, reads: dict, casts) -> list:
    """The reference's lines for ``reads``, once per precision in
    ``casts``, from one derivation of the index."""
    cfg = ctx.cell.config
    params = cfg["params"]
    index = reference.Index(st["genomes"], params["kmer_size"],
                            params["window_size"], ctx.device)
    return reference.expected_lines(
        index, params, st["names"], [len(g) for g in st["genomes"]], reads,
        casts, workers=min(core.HOST_THREADS, os.cpu_count() or 1),
        device=ctx.device)


def check(ctx, st):
    """Frees the program's state, then holds a sample of the timed files'
    reads, line for line, against the reference: [(number, value, limit)]."""
    _free_program(ctx, st)
    files = ctx.record["files"] + ctx.record.get("traced_files", [])
    written = {}

    def lines_of(fr):
        fi, r = fr
        if fi not in written:
            written[fi] = program_lines(files[fi]["prefix"])
        return written[fi].get(read_name(files[fi]["j"], r), [])

    pairs = sample(ctx, st, files, lambda fr: len(lines_of(fr)))
    reads = {read_name(files[fi]["j"], r): st["pool"][files[fi]["j"]][r]
             for fi, r in pairs}
    t0 = time.perf_counter()
    expected, = reference_lines(ctx, st, reads, [np.float32])
    differing = sum(lines_of(fr) != expected.get(
        read_name(files[fr[0]]["j"], fr[1]), []) for fr in pairs)
    core.log(f"reference: {len(pairs)} reads ({len(reads)} distinct) in "
             f"{time.perf_counter() - t0:.2f} s")
    limits = ctx.cell.traffic["limits"]
    return [("reads_differing", differing, limits["reads_differing"])]


def control(ctx, setup_mod, cast=reference.bf16) -> list:
    """The control's reading at the cell's size: the reference with its
    identity arithmetic in ``cast`` (bfloat16, the precision below the
    configuration's float32) in the program's place, against the reference,
    on a sample of the seed's pool drawn as a run draws it."""
    from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine

    cfg = ctx.cell.config
    genomes, names = setup_mod.genomes(cfg)
    pool = draw_pool(ctx.cell.traffic, genomes, setup_mod.read_shares(cfg),
                     ctx.seed)
    st = dict(genomes=genomes, names=names, pool=pool,
              buckets=tuple(sorted(TorchMapperEngine.DEFAULT_BUCKETS)))
    files = [dict(j=j) for j in range(len(pool))]
    reads = {read_name(j, r): pool[j][r] for j, r in sample(ctx, st, files)}
    want, got = reference_lines(ctx, st, reads, [np.float32, cast])
    return [("reads_differing", sum(got[n] != want[n] for n in want))]
