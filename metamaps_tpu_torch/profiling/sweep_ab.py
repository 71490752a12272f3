"""Two builds of a sweep kernel side by side on the same inputs.

Builds the kernel library from the sources in ``--base`` (a directory
holding a copy of ``metamaps_tpu_torch/csrc``, say of the parent commit
unpacked with ``git archive``) and from the package's own ``csrc``. For
each kernel named by ``--kernel`` (``batch``: ``l2_event_sweep_batch``,
``rb``: ``l2_event_sweep_rb``, ``eager``: ``l2_event_sweep`` at s_pad the
multiple of 1024 above sp), on each input, it checks that both builds give
the same output (and the plain version's, on the first slab) and times
each with CUDA events in the order base, new, new, base. The inputs are
the main-path slabs of ``chip_smoke.py``'s configuration (its synthetic
database, reads and seed; the first read chunk's L2 slabs), setup-shaped
and mixed streams (``paired_event_streams``) of 2048 candidates at sp 1280,
and the sweep bench's scenarios ``full`` (random signs), ``paired-full``,
``paired-big`` and ``mixed``.

    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/csrc
    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/csrc --kernel rb eager
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..cli import _add_sketch_args, _sketch_params
from ..engine.index import build_shards
from ..engine.mapper_torch import TorchMapperEngine
from ..io.fasta import read_sequences
from ..ops import l2_sweep
from ..sim.synth_db import ont_read, write_synth_db_dir
from .sweep_bench import bench_inputs, time_ms

#: each kernel's wrapper and its plane width at a candidate set's sp
KERNELS = {
    "batch": (l2_sweep.l2_event_sweep_batch, lambda sp: sp),
    "rb": (l2_sweep.l2_event_sweep_rb, lambda sp: sp),
    "eager": (l2_sweep.l2_event_sweep, lambda sp: -(-sp // 1024) * 1024),
}
BENCH_CASES = ("full", "paired-full", "paired-big", "mixed")


def library(csrc: Path):
    """The kernel library built from the sources in ``csrc``."""
    saved = l2_sweep.CSRC, l2_sweep._lib
    l2_sweep.CSRC, l2_sweep._lib = Path(csrc), None
    try:
        return l2_sweep.load_library()
    finally:
        l2_sweep.CSRC, l2_sweep._lib = saved


def slab_inputs(device, seed: int, genome_len: int, n_reads: int, workdir):
    """The main-path slabs of the first read chunk, as ``chip_smoke.py``
    draws its database and reads: [(label, [meta, qrank, signinq, rows],
    sp)]."""
    rng = np.random.default_rng(seed)
    db = os.path.join(workdir, "DB")
    write_synth_db_dir(db, rng, n_genera=12, species_per_genus=3,
                       genome_len=genome_len)
    genomes = [seq for _, seq in read_sequences(os.path.join(db, "DB.fa"))]
    reads = []
    for _ in range(n_reads):
        g = genomes[int(rng.integers(0, len(genomes)))]
        reads.append(ont_read(rng, g, int(rng.integers(3000, 7600)))[:8192])
    p = argparse.ArgumentParser()
    _add_sketch_args(p)
    params = _sketch_params(p.parse_known_args(
        ["--reference", os.path.join(db, "DB.fa"), "--query", "-",
         "--output", "-", "--all"])[0])
    shards = []
    build_shards(params, 0, lambda s, n: shards.append(s))
    engine = TorchMapperEngine(shards[0], params, device=device)
    b0 = engine._bucket_of(len(reads[0]))
    chunk = [r for r in reads if engine._bucket_of(len(r)) == b0]
    return [(f"slab {i}", [t.contiguous() for t in (st.meta, st.qrank,
                                                     st.signinq, st.rows)], sp)
            for i, (st, sp) in enumerate(
                engine.l2_slab_setups(chunk[: engine.CHUNK]))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True,
                    help="directory with the other build's csrc sources")
    ap.add_argument("--kernel", nargs="+", choices=sorted(KERNELS),
                    default=["batch"], help="the kernels to compare")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-len", type=int, default=3_000_000)
    ap.add_argument("--reads", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = {"base": library(Path(args.base)), "new": library(l2_sweep.CSRC)}
    work = l2_sweep.BUILD_DIR.parent / "sweep_ab"
    try:
        cases = slab_inputs(dev, args.seed, args.genome_len, args.reads,
                            str(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for flip, kind in ((0.0, "paired"), (0.04, "mixed")):
        host = l2_sweep.paired_event_streams(np.random.default_rng(1281), 2048,
                                             4000, 1279, flip=flip)
        cases.append((f"{kind} sp=1280",
                      [torch.from_numpy(a).to(dev) for a in host], 1280))
    for name, host, sp, _ in bench_inputs(only=BENCH_CASES):
        cases.append((f"bench {name}",
                      [torch.from_numpy(a).to(dev) for a in host], sp))

    def call(build, kernel, arrs, sp):
        fn, width = KERNELS[kernel]
        saved, l2_sweep._lib = l2_sweep._lib, libs[build]
        try:
            return fn(*arrs, width(sp))
        finally:
            l2_sweep._lib = saved

    results = {}
    for kernel in args.kernel:
        results[kernel] = {}
        for label, arrs, sp in cases:
            width = KERNELS[kernel][1](sp)
            outs = {b: call(b, kernel, arrs, sp) for b in libs}
            torch.cuda.synchronize()
            same = torch.equal(outs["base"], outs["new"])
            if label == "slab 0":
                same = same and torch.equal(
                    outs["new"], l2_sweep.l2_event_sweep_ref(*arrs, width))
            ms = {}
            for b in ("base", "new", "new", "base"):
                ms.setdefault(b, []).append(time_ms(
                    lambda: call(b, kernel, arrs, sp), dev, args.reps))
            n_ev = arrs[0][:, 3].clamp(0, arrs[1].shape[1])
            row = results[kernel][label] = dict(
                equal=same, ms=ms, N=int(arrs[1].shape[0]),
                E2=int(arrs[1].shape[1]), width=width,
                max_n_ev=int(n_ev.max()), sum_n_ev=int(n_ev.sum()))
            print(kernel, label, json.dumps(row), flush=True)
    print(json.dumps(results))
    return 0 if all(r["equal"] for rows in results.values()
                    for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
