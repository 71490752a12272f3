"""Two builds of a sweep kernel side by side on the same inputs.

``--base`` names the ``csrc`` directory of another copy of the package
(say the parent commit's, unpacked with ``git archive``); that copy's
``ops`` modules are imported under another name, so each build is called
through its own wrappers and builds its own kernel library under its own
``build/``. For each kernel named by ``--kernel`` (``batch``:
``l2_event_sweep_batch``, ``rb``: ``l2_event_sweep_rb``, ``eager``:
``l2_event_sweep`` at s_pad the multiple of 1024 above sp, ``parts``: the
ablation ``l2_sweep_parts``), on each input, it checks that both builds
give the same output (and the plain version's, on the first slab and on
every ablation mode) and times each with CUDA events in the order base,
new, new, base. The sweep kernels' inputs are the main-path slabs of
``chip_smoke.py``'s configuration (its synthetic database, reads and seed;
the first read chunk's L2 slabs), setup-shaped and mixed streams
(``paired_event_streams``) of 2048 candidates at sp 1280, and the sweep
bench's scenarios ``full`` (random signs), ``paired-full``, ``paired-big``
and ``mixed``; the ablation's are the sweep bench's (N 56, SP 1152, E2
4480) in its modes ``c``, ``cm``, ``cms`` and ``cmsf``, where the two
builds must agree on the outputs both write.

    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/metamaps_tpu_torch/csrc
    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/metamaps_tpu_torch/csrc --kernel rb eager parts
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
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
from ..ops import l2_sweep, l2_sweep_parts
from ..sim.synth_db import ont_read, write_synth_db_dir
from .sweep_bench import (
    PARTS_MODES,
    PARTS_SEED,
    PARTS_SHAPE,
    bench_inputs,
    parts_streams,
    time_ms,
)

#: each kernel's module, wrapper and plane width at a candidate set's sp
KERNELS = {
    "batch": ("l2_sweep", "l2_event_sweep_batch", lambda sp: sp),
    "rb": ("l2_sweep", "l2_event_sweep_rb", lambda sp: sp),
    "eager": ("l2_sweep", "l2_event_sweep",
              lambda sp: -(-sp // 1024) * 1024),
    "parts": ("l2_sweep_parts", "l2_sweep_parts", lambda sp: sp),
}
BENCH_CASES = ("full", "paired-full", "paired-big", "mixed")
BASE_NAME = "_sweep_ab_base"  # the other copy's import name


def base_ops(csrc: Path) -> dict:
    """The ``ops.l2_sweep`` and ``ops.l2_sweep_parts`` modules of the copy
    of the package that holds ``csrc``, imported as ``BASE_NAME``."""
    root = Path(csrc).resolve().parent
    spec = importlib.util.spec_from_file_location(
        BASE_NAME, root / "__init__.py", submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[BASE_NAME] = pkg
    spec.loader.exec_module(pkg)
    return {m: importlib.import_module(f"{BASE_NAME}.ops.{m}")
            for m in ("l2_sweep", "l2_sweep_parts")}


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
    mods = {"base": base_ops(Path(args.base)),
            "new": {"l2_sweep": l2_sweep, "l2_sweep_parts": l2_sweep_parts}}
    for build in mods.values():  # both libraries, before any timing
        build["l2_sweep"].load_library()
    cases = []  # (label, inputs on the card, sp, ablation mode or None)
    if set(args.kernel) - {"parts"}:
        work = l2_sweep.BUILD_DIR.parent / "sweep_ab"
        try:
            cases += [(label, arrs, sp, None) for label, arrs, sp in
                      slab_inputs(dev, args.seed, args.genome_len,
                                  args.reads, str(work))]
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for flip, kind in ((0.0, "paired"), (0.04, "mixed")):
            host = l2_sweep.paired_event_streams(
                np.random.default_rng(1281), 2048, 4000, 1279, flip=flip)
            cases.append((f"{kind} sp=1280",
                          [torch.from_numpy(a).to(dev) for a in host], 1280,
                          None))
        for name, host, sp, _ in bench_inputs(only=BENCH_CASES):
            cases.append((f"bench {name}",
                          [torch.from_numpy(a).to(dev) for a in host], sp,
                          None))
    n, sp, e2 = PARTS_SHAPE
    parts_arrs = [torch.from_numpy(a).to(dev)
                  for a in parts_streams(n, sp, e2, PARTS_SEED)]
    parts_cases = [(f"bench mode {mode}", parts_arrs, sp, mode)
                   for mode in PARTS_MODES]

    def call(build, kernel, arrs, sp, mode):
        module, fn, width = KERNELS[kernel]
        fn = getattr(mods[build][module], fn)
        return fn(*arrs, width(sp), *([mode] if mode else []))

    def same_outputs(a, b):
        """Equal outputs; of the ablation, those both builds write."""
        if isinstance(a, tuple):
            return all(map(torch.equal, a, b))
        return torch.equal(a, b)

    results = {}
    for kernel in args.kernel:
        results[kernel] = {}
        for label, arrs, sp, mode in parts_cases if kernel == "parts" \
                else [c for c in cases if c[3] is None]:
            width = KERNELS[kernel][2](sp)
            outs = {b: call(b, kernel, arrs, sp, mode) for b in mods}
            torch.cuda.synchronize()
            same = same_outputs(outs["base"], outs["new"])
            if kernel == "parts":
                same = same and same_outputs(outs["new"],
                                             l2_sweep_parts.l2_sweep_parts_ref(
                                                 *arrs, sp, mode))
            elif label == "slab 0":
                same = same and torch.equal(
                    outs["new"], l2_sweep.l2_event_sweep_ref(*arrs, width))
            ms = {}
            for b in ("base", "new", "new", "base"):
                ms.setdefault(b, []).append(time_ms(
                    lambda: call(b, kernel, arrs, sp, mode), dev, args.reps))
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
