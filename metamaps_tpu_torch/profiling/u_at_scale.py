"""The novel-species ("U") chain at the 1 Gbp bench's scale.

Counterpart of ``profiling/u_at_scale.py``. It writes a database directory
around the bench's genomes (``profiling/bench.py``: seed 20260820, 1 Gbp),
then runs the reference chain on the bench's 16,384-read mappings:

  classify (doEM, fEM.h:466; the EM rounds on ``--device``)
    -> selfSimilarity (estimateSelfSimilarity.pl prepare / doJobI / collect)
    -> classifyU (doU, fU.h:1085)

The ``selfSimilarity`` workload is reduced, as in the JAX script, and the
record says so (``SIM_KW``: chunk lengths 2000..10000 step 4000, at most 60
chunks a length, against the reference's 2000..50000 step 1000, at most
2000: an SGE-cluster workload, estimateSelfSimilarity.pl:36-43,180-186).
Jobs start while the run is inside ``--budget-s``, and ``collect``
tolerates missing jobs by design (estimateSelfSimilarity.pl:1262-1305).
``--jobs`` runs a fixed subset and ``--workers N`` runs the jobs in N
worker processes, one fresh process a job: jobs are independent (the
reference spreads them over SGE) and each writes its own
``results/<i>.json``. Neither changes what a job computes.

Beyond the JAX record's keys, the record (``--out``, by default
``build/u_at_scale/record.json``) holds the card's name and power limit,
the EM rounds' device and whether the seven ``.EM*`` files equal those of
``classify --emBackend numpy`` on a copy of the mappings, each job's B
bases (the genomes its chunks map against), seconds and, where it ran in
a worker process, peak resident bytes, the workers, and the split of the slowest job: run once more under
``cProfile``, the cumulative seconds of reading ``DB.fa``
(``_load_db_contigs``), winnowing the B genomes (``winnow_fast``),
building their index (``SketchShard.finalize``) and the serial oracle's
chunk mapping (``mapper_oracle.map_read``).

    python -m metamaps_tpu_torch.profiling.bench --dump-mappings \\
        .bench_cache/torch/bench_mappings_16k.txt
    python -m metamaps_tpu_torch.profiling.u_at_scale --workers 4

The directory is written around ``DB_BASES`` bases where ``--db-dir`` has
no ``taxonInfo.txt``; for a smaller run, write it first with
``build_db_dir`` on ``bench.synth_genomes(bases, bench.LARGE_SEED)``.
"""
from __future__ import annotations

import argparse
import cProfile
import functools
import json
import multiprocessing
import os
import pstats
import resource
import shutil
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait

import numpy as np

from ..cli import main as cli_main
from ..db import self_similarity as ss
from ..device import require_cuda
from ..engine.em import load_relevant_taxon_info
from ..io import native
from ..stats import acceptance_vec
from . import bench

MAPPINGS = os.path.join(bench.CACHE_DIR, "bench_mappings_16k.txt")
DB_DIR = os.path.join(bench.CACHE_DIR, "u_db")
OUT = os.path.join(bench.ROOT, "build", "u_at_scale", "record.json")
DB_BASES = bench.LARGE_BASES
SIM_KW = dict(sim_from=2000, sim_to=10000, sim_step=4000, max_chunks=60)
BUDGET_S = 5400
MIN_READS = 100
# the files bench.dump_mappings writes (classify reads them)
MAPPING_FILES = ("", ".meta", ".meta.unmappedReadsLengths", ".parameters")
EM_FILES = (".EM", ".EM.WIMP", ".EM.reads2Taxon", ".EM.reads2Taxon.krona",
            ".EM.contigCoverage", ".EM.evidenceUnknownSpecies",
            ".EM.lengthAndIdentitiesPerMappingUnit")
# (function, the end of its file's path): the parts of a job's split
SPLIT = {"load_db_contigs_s": ("_load_db_contigs", "db/self_similarity.py"),
         "winnow_fast_s": ("winnow_fast", "ops/winnow.py"),
         "finalize_s": ("finalize", "engine/index.py"),
         "map_read_s": ("map_read", "engine/mapper_oracle.py")}
# a job maps its chunks at k 16 and --pi 80 (self_similarity._map_chunks)
SIM_K, SIM_PI = 16, 80.0


def build_db_dir(db_dir: str, genomes, names) -> int:
    """Write the database directory around ``genomes``: ``DB.fa`` (lines of
    10,000 bases), ``taxonInfo.txt``, ``contigNstats_windowSize_1000.txt``
    and ``taxonomy/{names,nodes,merged}.dmp`` (root -> Bacteria -> 2
    families -> 4 genera -> 12 species, and under its source species one
    ``x2000+di`` pseudo-node for each duplicated genome, as
    annotateRefSeqSequences names them). Returns the bases written."""
    os.makedirs(os.path.join(db_dir, "taxonomy"), exist_ok=True)

    def dmp(*fields):
        return "\t|\t".join(str(f) for f in fields) + "\t|\n"

    with open(os.path.join(db_dir, "taxonomy", "names.dmp"), "w") as nf, \
            open(os.path.join(db_dir, "taxonomy", "nodes.dmp"), "w") as df:
        nf.write(dmp(1, "root", "", "scientific name"))
        df.write(dmp(1, 1, "no rank"))
        nf.write(dmp(2, "Bacteria", "", "scientific name"))
        df.write(dmp(2, 1, "superkingdom"))
        for fam in range(2):
            nf.write(dmp(50 + fam, f"Family{fam}", "", "scientific name"))
            df.write(dmp(50 + fam, 2, "family"))
        for g in range(4):
            nf.write(dmp(100 + g, f"Genus{g}", "", "scientific name"))
            df.write(dmp(100 + g, 50 + g % 2, "genus"))
        for i in range(12):
            nf.write(dmp(1000 + i, f"Species{i}", "", "scientific name"))
            df.write(dmp(1000 + i, 100 + i % 4, "species"))
        # a duplicated genome's name carries its x-taxon and its source
        # genome: G12_dup{src}|kraken:taxid|x{2000 + di}|...
        for di, name in enumerate(n for n in names if "|x" in n):
            src = int(name.split("_dup")[1].split("|")[0])
            nf.write(dmp(f"x{2000 + di}", f"Species{src} genome {di + 2}",
                         "", "scientific name"))
            df.write(dmp(f"x{2000 + di}", 1000 + src, "no rank"))
    with open(os.path.join(db_dir, "taxonomy", "merged.dmp"), "w") as f:
        f.write("")

    bench.write_db_fasta(os.path.join(db_dir, "DB.fa"), genomes, names)
    with open(os.path.join(db_dir, "taxonInfo.txt"), "w") as ti, \
            open(os.path.join(db_dir,
                              "contigNstats_windowSize_1000.txt"), "w") as ns:
        for g, name in zip(genomes, names):
            tax = name.split("kraken:taxid|")[1].split("|")[0]
            ti.write(f"{tax} {name}={len(g)}\n")
            nw = (len(g) + 999) // 1000
            ns.write(f"{tax}\t{name}\t" + ";".join(["0"] * nw) + "\n")
    return sum(len(g) for g in genomes)


def job_b_bases(db_dir: str, jobs) -> list:
    """Bases of each job's B genomes (those its chunks map against), from
    ``taxonInfo.txt``."""
    taxon_info = load_relevant_taxon_info(db_dir, set())
    return [sum(sum(taxon_info[t].values()) for t in job.b_taxa)
            for job in jobs]


def fewest_b_jobs(db_dir: str, jobs, n: int) -> list:
    """Indices of the ``n`` jobs with the fewest B bases (ties to the
    lower index), in index order."""
    b = job_b_bases(db_dir, jobs)
    return sorted(sorted(range(len(jobs)), key=lambda i: (b[i], i))[:n])


@functools.lru_cache(maxsize=None)
def identity_floor(length: int) -> int:
    """The lowest identity a job's histogram can hold for chunks of
    ``length`` bases. A chunk maps where its identity's upper bound
    reaches ``--pi`` (``engine/mapper_oracle.py:map_read``, the
    reference's doL2Mapping), so identities below ``--pi`` are admitted:
    for each sketch size s a chunk can have (1 to its ``length - k + 1``
    k-mers), the fewest shared minimizers whose bound reaches ``--pi``
    give that sketch's lowest identity. The floor is the lowest over all
    s, rounded as the histogram rounds it (73 at k 16, ``--pi`` 80, at
    s = 144, from 2000 bases up)."""
    s = np.arange(1, length - SIM_K + 2, dtype=np.int64)
    lo, hi = np.ones_like(s), s.copy()  # the bound grows with the hits
    while (lo < hi).any():
        mid = (lo + hi) // 2
        ok = acceptance_vec(mid, s, SIM_K, SIM_PI)[2]
        hi = np.where((lo < hi) & ok, mid, hi)
        lo = np.where((lo < hi) & ~ok, mid + 1, lo)
    nuc, _, ok = acceptance_vec(lo, s, SIM_K, SIM_PI)
    return int(float(nuc[ok].min()) + 0.5)


def _peak_rss_bytes() -> int:
    # ru_maxrss is in KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_one(db_dir: str, job, out_dir: str, i: int, sim_kw: dict) -> dict:
    """One job (``self_similarity.run_job``) in a worker process: its
    seconds and the peak resident bytes of the worker, before and after
    the job. A spawned worker's peak starts at least at that of the
    process it was spawned from (Linux keeps ``ru_maxrss`` across the
    exec), so the job's own peak is the one after where it exceeds the
    one before."""
    before = _peak_rss_bytes()
    t0 = time.perf_counter()
    ss.run_job(db_dir, job, out_dir, i, **sim_kw)
    return {"seconds": time.perf_counter() - t0,
            "peak_rss_bytes": _peak_rss_bytes(),
            "peak_rss_before_bytes": before}


def run_jobs(db_dir: str, out_dir: str, jobs, todo, sim_kw: dict,
             workers: int, budget_s: float, t0: float) -> dict:
    """Run the jobs ``todo`` (indices into ``jobs``) that have no result
    yet, starting each while ``budget_s`` seconds since ``t0`` have not
    passed: in this process with ``workers`` 1 (no peak resident bytes:
    this process's peak is not the job's), else in ``workers`` spawned
    processes, a fresh one a job. Returns {job index: ``run_one``'s dict}
    of the jobs run."""
    pending = [i for i in todo if not os.path.exists(
        os.path.join(out_dir, "results", f"{i}.json"))]
    done: dict = {}

    def finished(i, row):
        done[i] = row
        peak = ("" if row["peak_rss_bytes"] is None else
                f", peak {row['peak_rss_bytes'] / 2**30:.2f} GiB (before "
                f"the job {row['peak_rss_before_bytes'] / 2**30:.2f})")
        print(f"# selfSim job {i}/{len(jobs)}: {row['seconds']:.1f} s"
              + peak, flush=True)

    if workers <= 1:
        for i in pending:
            if time.perf_counter() - t0 > budget_s:
                break
            t1 = time.perf_counter()
            ss.run_job(db_dir, jobs[i], out_dir, i, **sim_kw)
            finished(i, {"seconds": time.perf_counter() - t1,
                         "peak_rss_bytes": None,
                         "peak_rss_before_bytes": None})
        return done
    # the workers read DB.fa and winnow with the native helpers: build
    # them once here, not in each worker at once
    native.available()
    native.winnow_native(np.full(64, ord("A"), np.uint8), 16, 8)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        running: dict = {}  # future -> job index
        while pending or running:
            while (pending and len(running) < workers
                   and time.perf_counter() - t0 <= budget_s):
                i = pending.pop(0)
                running[pool.submit(run_one, db_dir, jobs[i], out_dir, i,
                                    sim_kw)] = i
            if not running:
                break  # out of budget
            ready, _ = wait(running, return_when=FIRST_COMPLETED)
            for fut in ready:
                finished(running.pop(fut), fut.result())
    return done


def job_split(db_dir: str, job, i: int, scratch: str, sim_kw: dict) -> dict:
    """Job ``i`` once more under ``cProfile`` (results under ``scratch``,
    removed after): its seconds and the cumulative seconds of each part of
    ``SPLIT``."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    try:
        prof.runcall(ss.run_job, db_dir, job, scratch, i, **sim_kw)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out = {"job": i, "profiled_s": time.perf_counter() - t0}
    stats = pstats.Stats(prof).stats
    for key, (fn, path_end) in SPLIT.items():
        out[key] = sum(row[3] for (path, _, name), row in stats.items()
                       if name == fn and path.replace(os.sep, "/")
                       .endswith(path_end))
    return out


def job_checks(out_dir: str, todo) -> list:
    """Failures of the jobs ``todo``'s results: a missing result, a
    histogram that counts more chunks of a length than the job drew, an
    identity outside [``identity_floor(length)``, 100]."""
    failures = []
    for i in todo:
        fn = os.path.join(out_dir, "results", f"{i}.json")
        if not os.path.exists(fn):
            failures.append(f"job {i}: no result")
            continue
        with open(fn) as f:
            hist = json.load(f)
        with open(os.path.join(out_dir, "results", f"{i}.reads.json")) as f:
            drawn: dict = {}
            for length, _ci, _pos in json.load(f)["chunks"]:
                drawn[str(length)] = drawn.get(str(length), 0) + 1
        for length, counts in hist.items():
            if sum(counts.values()) > drawn.get(length, 0):
                failures.append(f"job {i}: {sum(counts.values())} chunks of "
                                f"{length} counted, {drawn.get(length, 0)} "
                                "drawn")
            floor = identity_floor(int(length))
            bad = [k for k in counts if not floor <= int(k) <= 100]
            if bad:
                failures.append(f"job {i}: identities {bad} at {length}")
    return failures


def same_em_files(a: str, b: str) -> dict:
    """{suffix: the two ``.EM*`` files hold the same, non-empty bytes}."""
    out = {}
    for suffix in EM_FILES:
        with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
            want = fa.read()
            out[suffix] = bool(want) and want == fb.read()
    return out


def _lines(path: str) -> int:
    with open(path) as f:
        return sum(1 for _ in f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mappings", default=MAPPINGS,
                    help="a mappings file with the sidecars that "
                    "`profiling.bench --dump-mappings FILE` writes")
    ap.add_argument("--db-dir", default=DB_DIR,
                    help="the database directory (written around the "
                    "bench's 1 Gbp genomes if it has no taxonInfo.txt)")
    ap.add_argument("--budget-s", type=float, default=BUDGET_S,
                    help="no selfSimilarity job starts after this many "
                    "seconds of the step")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of classify's EM rounds")
    ap.add_argument("--minreads", type=int, default=MIN_READS)
    ap.add_argument("--jobs", default=None, metavar="I,J,...",
                    help="run only these selfSimilarity jobs")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker processes for the selfSimilarity jobs")
    ap.add_argument("--no-split", action="store_true",
                    help="do not rerun the slowest job under cProfile")
    ap.add_argument("--out", default=OUT, help="the record (JSON)")
    args = ap.parse_args(argv)
    device = require_cuda(args.device)
    mappings, db_dir = args.mappings, args.db_dir
    if not os.path.exists(mappings):
        raise FileNotFoundError(
            f"{mappings}: run `python -m metamaps_tpu_torch.profiling.bench "
            f"--dump-mappings {mappings}` first")
    work = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(work, exist_ok=True)
    sim_kw = dict(SIM_KW)
    rec = {"artifact": "U pipeline at bench scale",
           "date": time.strftime("%Y-%m-%d"),
           "mappings": os.path.basename(mappings),
           "mapping_lines": _lines(mappings),
           "card": bench.card_name(device), "em_device": str(device)}

    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(db_dir, "taxonInfo.txt")):
        _, genomes, names = bench.synth_genomes(DB_BASES, bench.LARGE_SEED)
        rec["db_bases"] = build_db_dir(db_dir, genomes, names)
        del genomes
        rec["db_build_s"] = time.perf_counter() - t0
    print(f"# DB dir ready ({rec.get('db_build_s', 'cached')})", flush=True)

    # --- classify (EM), then the same on the host in a copy ---------------
    minreads = ["--minreads", str(args.minreads)]
    t0 = time.perf_counter()
    if cli_main(["classify", "--mappings", mappings, "--DB", db_dir,
                 "--device", args.device, *minreads]) != 0:
        raise RuntimeError("classify failed")
    rec["classify_s"] = time.perf_counter() - t0
    rec["em_wimp_rows"] = _lines(mappings + ".EM.WIMP") - 1
    print(f"# classify: {rec['classify_s']:.2f} s", flush=True)
    host_dir = os.path.join(work, "em_numpy")
    os.makedirs(host_dir, exist_ok=True)
    host = os.path.join(host_dir, os.path.basename(mappings))
    for suffix in MAPPING_FILES:
        shutil.copy(mappings + suffix, host + suffix)
    t0 = time.perf_counter()
    if cli_main(["classify", "--mappings", host, "--DB", db_dir,
                 "--emBackend", "numpy", *minreads]) != 0:
        raise RuntimeError("classify --emBackend numpy failed")
    rec["classify_numpy_s"] = time.perf_counter() - t0
    rec["em_equal_numpy"] = same_em_files(mappings, host)
    shutil.rmtree(host_dir)

    # --- selfSimilarity ---------------------------------------------------
    out_dir = os.path.join(db_dir, "selfSimilarity")
    t0 = time.perf_counter()
    jobs = ss.prepare(db_dir, out_dir)
    todo = (list(range(len(jobs))) if args.jobs is None
            else [int(i) for i in args.jobs.split(",")])
    rec.update(selfsim_jobs_total=len(jobs), selfsim_params=dict(sim_kw),
               selfsim_reduced=(
                   "chunk lengths {sim_from}..{sim_to} step {sim_step}, at "
                   "most {max_chunks} chunks a length".format(**sim_kw)
                   + f" (reference: {ss.SIM_SIZE_FROM}..{ss.SIM_SIZE_TO} "
                   f"step {ss.SIM_SIZE_STEP}, at most "
                   f"{ss.TARGET_MAX_CHUNKS})"),
               selfsim_workers=args.workers,
               selfsim_job_b_bases=job_b_bases(db_dir, jobs),
               selfsim_jobs_asked=todo)
    ran = run_jobs(db_dir, out_dir, jobs, todo, sim_kw, args.workers,
                   args.budget_s, t0)
    rec["selfsim_jobs_done"] = sum(
        os.path.exists(os.path.join(out_dir, "results", f"{i}.json"))
        for i in todo)
    rec["selfsim_jobs_run"] = sorted(ran)
    rec["selfsim_job_s"] = [ran[i]["seconds"] for i in sorted(ran)]
    for key in ("peak_rss_bytes", "peak_rss_before_bytes"):
        rec[f"selfsim_job_{key}"] = [ran[i][key] for i in sorted(ran)]
    rec["selfsim_jobs_s"] = time.perf_counter() - t0
    print(ss.collect(db_dir, out_dir), flush=True)
    rec["selfsim_total_s"] = time.perf_counter() - t0
    rec["selfsim_lines"] = _lines(os.path.join(db_dir, "selfSimilarities.txt"))
    rec["selfsim_check_failures"] = job_checks(out_dir, sorted(ran))

    # --- classifyU --------------------------------------------------------
    t0 = time.perf_counter()
    if cli_main(["classifyU", "--mappings", mappings, "--DB", db_dir,
                 *minreads]) != 0:
        raise RuntimeError("classifyU failed")
    rec["classifyU_s"] = time.perf_counter() - t0
    rec["u_wimp_rows"] = _lines(mappings + ".U.WIMP") - 1
    rec["u_reads2taxon_rows"] = _lines(mappings + ".U.reads2Taxon")
    print(f"# classifyU: {rec['classifyU_s']:.2f} s", flush=True)

    # --- where the slowest job's time goes --------------------------------
    if ran and not args.no_split:
        slowest = max(ran, key=lambda i: ran[i]["seconds"])
        rec["selfsim_job_split"] = job_split(
            db_dir, jobs[slowest], slowest, os.path.join(work, "split_job"),
            sim_kw)
        print("# split: " + json.dumps(rec["selfsim_job_split"]), flush=True)

    bench.write_replace(args.out, lambda tmp: _write_json(tmp, rec))
    print(json.dumps(rec), flush=True)
    ok = all(rec["em_equal_numpy"].values()) and not rec[
        "selfsim_check_failures"]
    return 0 if ok else 1


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
