"""``index`` + ``mapAgainstIndex`` at 1 Gbp, byte for byte against
``mapDirectly``.

Counterpart of ``profiling/map_against_index_1g.py``: the stored-index
contract (mapWrap.h:358-531) at the bench's size. It writes ``DB.fa`` from
the bench's 1 Gbp genomes (``profiling/bench.py``: seed 20260820, the names
``synth_structured_db`` gives) and a FASTQ of the bench's first 2048
reads, stores the index through the port's CLI (``index --window 16 --pi
80 --minReadLen 2000``), maps the reads with ``mapAgainstIndex``, then
with ``mapDirectly`` on the same inputs, and checks that the mappings,
``.meta`` and ``.meta.unmappedReadsLengths`` are byte-equal. Everything,
its record ``record.json`` (seconds of each step, the engines' counters,
the verdict) included, goes under ``--workdir``.

    python -m metamaps_tpu_torch.profiling.map_against_index_1g
    python -m metamaps_tpu_torch.profiling.map_against_index_1g --bases 2000000 --reads 32 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..cli import main as cli_main
from ..device import require_cuda
from . import bench

N_READS = 2048
WORKDIR = os.path.join(bench.ROOT, "build", "map_against_index_1g")
SKETCH_ARGS = ["--window", "16", "--pi", "80", "--minReadLen", "2000"]
OUTPUTS = ("", ".meta", ".meta.unmappedReadsLengths")


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bases", type=int, default=bench.LARGE_BASES)
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=WORKDIR)
    args = ap.parse_args(argv)
    device = require_cuda(args.device)
    work = args.workdir
    os.makedirs(work, exist_ok=True)
    db_fa = os.path.join(work, "DB.fa")
    fq = os.path.join(work, "reads.fastq")
    prefix = os.path.join(work, "idx")
    rec = {"bases": args.bases, "seed": bench.LARGE_SEED,
           "n_reads": args.reads, "device": str(device),
           "card": bench.card_name(device)}

    t0 = time.perf_counter()
    rng, genomes, names = bench.synth_genomes(args.bases, bench.LARGE_SEED)
    reads = bench.draw_reads(rng, genomes, args.reads)
    rec["synth_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench.write_db_fasta(db_fa, genomes, names)
    bench.write_fastq(fq, reads)
    del genomes, reads
    rec["write_s"] = time.perf_counter() - t0

    def run(step: str, argv_step) -> dict:
        stats: dict = {}
        t0 = time.perf_counter()
        if cli_main(argv_step, engine_stats=stats) != 0:
            raise RuntimeError(f"{step} failed")
        rec[f"{step}_s"] = time.perf_counter() - t0
        if stats:
            rec[f"{step}_engine"] = stats
        return stats

    # --threads: mapDirectly's index build winnows on every core (the
    # output does not depend on it; index has no such option)
    query = ["--all", "--threads", str(os.cpu_count() or 2), "--device",
             args.device]
    run("index", ["index", "--reference", db_fa, "--index", prefix]
        + SKETCH_ARGS)
    rec["index_bytes"] = sum(
        os.path.getsize(os.path.join(work, f))
        for f in os.listdir(work) if f.startswith("idx"))
    out_ai = os.path.join(work, "out_ai")
    run("mapAgainstIndex", ["mapAgainstIndex", "--index", prefix, "--query",
                            fq, "--output", out_ai] + query)
    out_d = os.path.join(work, "out_d")
    run("mapDirectly", ["mapDirectly", "--reference", db_fa, "--query", fq,
                        "--output", out_d] + SKETCH_ARGS + query)

    rec["byte_equal"] = {suffix or "mappings": same_bytes(out_ai + suffix,
                                                          out_d + suffix)
                         for suffix in OUTPUTS}
    with open(out_ai) as f:
        rec["mapping_lines"] = sum(1 for _ in f)
    bench.write_replace(os.path.join(work, "record.json"),
                         lambda tmp: _write_json(tmp, rec))
    print(json.dumps(rec), flush=True)
    return 0 if all(rec["byte_equal"].values()) else 1


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
