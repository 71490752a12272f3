"""Two builds of a sweep kernel side by side on the same inputs.

``--base`` names the ``csrc`` directory of another copy of the package
(say the parent commit's, unpacked with ``git archive``); that copy's
``ops`` modules are imported under another name, so each build is called
through its own wrappers and builds its own kernel library under its own
``build/``. For each kernel named by ``--kernel`` (``batch``:
``l2_event_sweep_batch``, ``rb``: ``l2_event_sweep_rb``, ``eager``:
``l2_event_sweep`` at s_pad the multiple of 1024 above sp, ``parts``: the
ablation ``l2_sweep_parts``, ``wide``: ``l2_event_sweep_wide``), on each
input, it checks that both builds give the same output (and the plain
version's, on the first slab, on the short wide streams and on every
ablation mode) and times each with CUDA events in the order base, new,
new, base. The sweep kernels' inputs are the main-path slabs of
``chip_smoke.py``'s configuration (its synthetic database, reads and seed;
the first read chunk's L2 slabs), setup-shaped and mixed streams
(``paired_event_streams``) of 2048 candidates at sp 1280, and the sweep
bench's scenarios ``full`` (random signs), ``paired-full``, ``paired-big``
and ``mixed``; the ablation's are the sweep bench's (N 56, SP 1152, E2
4480) in its modes ``c``, ``cm``, ``cms`` and ``cmsf``, where the two
builds must agree on the outputs both write. The wide kernel's are the
slab of ``chip_smoke.py``'s long read (62 kb of genome 0 at ``--pi 60
--window 3``, drawn after the reads from the same seed: 1 candidate,
185,344 event slots, sp 30,848), one setup-shaped candidate of that shape
(``long_event_stream``), paired and mixed, and 37 candidates of 300
random-sign and paired events at sp 28,928; ``--chunk-events`` also times
the new build at those chunk lengths on the long cases.

    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/metamaps_tpu_torch/csrc
    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/metamaps_tpu_torch/csrc --kernel rb eager parts
    python -m metamaps_tpu_torch.profiling.sweep_ab --base OLD/metamaps_tpu_torch/csrc --kernel wide --chunk-events 256 1024 2048
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
    "wide": ("l2_sweep", "l2_event_sweep_wide", lambda sp: sp),
}
#: chip_smoke.py's long read: bp, and the arguments that bring its slab to
#: the wide kernel (minimum hits ~19; at --pi 75, ~250, it goes there too)
LONG_READ = 62_000
LONG_READ_ARGS = ["--pi", "60", "--window", "3"]
LONG_SHAPE = (185_344, 30_848)  # E2, sp of the long read's slab
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


def draw_data(seed: int, genome_len: int, n_reads: int, workdir):
    """``chip_smoke.py``'s synthetic database and reads: (its directory,
    the genomes, the reads, the generator as it stands after them)."""
    rng = np.random.default_rng(seed)
    db = os.path.join(workdir, "DB")
    write_synth_db_dir(db, rng, n_genera=12, species_per_genus=3,
                       genome_len=genome_len)
    genomes = [seq for _, seq in read_sequences(os.path.join(db, "DB.fa"))]
    reads = []
    for _ in range(n_reads):
        g = genomes[int(rng.integers(0, len(genomes)))]
        reads.append(ont_read(rng, g, int(rng.integers(3000, 7600)))[:8192])
    return db, genomes, reads, rng


def _engine(device, reference: str, extra=()):
    p = argparse.ArgumentParser()
    _add_sketch_args(p)
    params = _sketch_params(p.parse_known_args(
        ["--reference", reference, "--query", "-", "--output", "-", "--all",
         *extra])[0])
    shards = []
    build_shards(params, 0, lambda s, n: shards.append(s))
    return TorchMapperEngine(shards[0], params, device=device)


def _slabs(engine, reads, label):
    return [(f"{label} {i}", [t.contiguous() for t in (st.meta, st.qrank,
                                                        st.signinq, st.rows)],
             sp) for i, (st, sp) in enumerate(engine.l2_slab_setups(reads))]


def slab_inputs(device, db: str, reads):
    """The main-path slabs of the first read chunk, as ``chip_smoke.py``
    maps them: [(label, [meta, qrank, signinq, rows], sp)]."""
    engine = _engine(device, os.path.join(db, "DB.fa"))
    b0 = engine._bucket_of(len(reads[0]))
    chunk = [r for r in reads if engine._bucket_of(len(r)) == b0]
    return _slabs(engine, chunk[: engine.CHUNK], "slab")


def long_read_inputs(device, rng, genome0, workdir):
    """The slab of ``chip_smoke.py``'s long read, drawn from ``rng`` (as
    :func:`draw_data` leaves it) and mapped against genome 0 alone."""
    pos = int(rng.integers(0, len(genome0) - LONG_READ))
    read = ont_read(rng, genome0[pos:pos + LONG_READ + 1], LONG_READ)
    ref = os.path.join(workdir, "long_read_ref.fa")
    with open(ref, "w") as f:
        f.write(f">genome0\n{genome0.tobytes().decode()}\n")
    return _slabs(_engine(device, ref, LONG_READ_ARGS), [read],
                  "long-read slab")


def wide_streams(device):
    """The wide kernel's synthetic cases: [(label, inputs, sp)]."""
    e2, sp = LONG_SHAPE
    cases = []
    for kind, flip in (("paired", 0.0), ("mixed", 0.04)):
        host = l2_sweep.long_event_stream(np.random.default_rng(e2), e2,
                                          sp - 1, flip=flip)
        cases.append((f"long {kind} 1x{e2}", host, sp))
    rng = np.random.default_rng(28928)
    cases.append(("random 37x300", l2_sweep.random_event_streams(
        rng, 37, 300, 28927), 28928))
    cases.append(("paired 37x300", l2_sweep.paired_event_streams(
        rng, 37, 300, 28927), 28928))
    return [(label, [torch.from_numpy(a).to(device) for a in host], sp)
            for label, host, sp in cases]


def kernel_ms(fn, device, reps: int) -> dict:
    """Device milliseconds per call of each kernel that ``fn`` launches,
    by ``torch.profiler`` over ``reps`` calls after a warm-up call, keyed
    by the kernel's name (its C++ function name where it is mangled)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            name = ev.key
            for part in name.replace("(", " ").split():
                if "kernel" in part:  # _ZN...17wide_chunk_kernelEPKi...
                    name = part
                    break
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


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
    ap.add_argument("--chunk-events", type=int, nargs="*", default=[],
                    help="chunk lengths at which to time the new wide "
                         "kernel on the long cases as well")
    ap.add_argument("--profile", action="store_true",
                    help="with --kernel wide: the new build's device time "
                         "per kernel (torch.profiler) on the long cases, "
                         "at the default chunk length and at each of "
                         "--chunk-events")
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
    cases = {}  # kernel -> [(label, inputs on the card, sp, mode or None)]
    sweeps = set(args.kernel) & {"batch", "rb", "eager"}
    if sweeps or "wide" in args.kernel:
        work = l2_sweep.BUILD_DIR.parent / "sweep_ab"
        try:
            db, genomes, reads, rng = draw_data(args.seed, args.genome_len,
                                                args.reads, str(work))
            slabs = slab_inputs(dev, db, reads) if sweeps else []
            long_slab = (long_read_inputs(dev, rng, genomes[0], str(work))
                         if "wide" in args.kernel else [])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        sweep_cases = list(slabs)
        for flip, kind in ((0.0, "paired"), (0.04, "mixed")):
            host = l2_sweep.paired_event_streams(
                np.random.default_rng(1281), 2048, 4000, 1279, flip=flip)
            sweep_cases.append((f"{kind} sp=1280",
                                [torch.from_numpy(a).to(dev) for a in host],
                                1280))
        for name, host, sp, _ in bench_inputs(only=BENCH_CASES):
            sweep_cases.append((f"bench {name}",
                                [torch.from_numpy(a).to(dev) for a in host],
                                sp))
        for kernel in sweeps:
            cases[kernel] = [(*c, None) for c in sweep_cases]
        cases["wide"] = [(*c, None) for c in long_slab + wide_streams(dev)]
    n, sp, e2 = PARTS_SHAPE
    parts_arrs = [torch.from_numpy(a).to(dev)
                  for a in parts_streams(n, sp, e2, PARTS_SEED)]
    cases["parts"] = [(f"bench mode {mode}", parts_arrs, sp, mode)
                      for mode in PARTS_MODES]

    def call(build, kernel, arrs, sp, mode, **kw):
        module, fn, width = KERNELS[kernel]
        fn = getattr(mods[build][module], fn)
        return fn(*arrs, width(sp), *([mode] if mode else []), **kw)

    def same_outputs(a, b):
        """Equal outputs; of the ablation, those both builds write."""
        if isinstance(a, tuple):
            return all(map(torch.equal, a, b))
        return torch.equal(a, b)

    results = {}
    for kernel in args.kernel:
        results[kernel] = {}
        for label, arrs, sp, mode in cases[kernel]:
            width = KERNELS[kernel][2](sp)
            outs = {b: call(b, kernel, arrs, sp, mode) for b in mods}
            torch.cuda.synchronize()
            same = same_outputs(outs["base"], outs["new"])
            if kernel == "parts":
                same = same and same_outputs(outs["new"],
                                             l2_sweep_parts.l2_sweep_parts_ref(
                                                 *arrs, sp, mode))
            elif label == "slab 0" or label.endswith("37x300"):
                same = same and torch.equal(
                    outs["new"], l2_sweep.l2_event_sweep_ref(*arrs, width))
            # fewer repetitions where one base call takes seconds (the old
            # wide kernel's recount on a long mixed stream)
            one = time_ms(lambda: call("base", kernel, arrs, sp, mode), dev, 1)
            reps = max(1, min(args.reps, int(2000 / max(one, 1e-3))))
            ms = {}
            for b in ("base", "new", "new", "base"):
                ms.setdefault(b, []).append(time_ms(
                    lambda: call(b, kernel, arrs, sp, mode), dev, reps))
            n_ev = arrs[0][:, 3].clamp(0, arrs[1].shape[1])
            row = results[kernel][label] = dict(
                equal=same, ms=ms, reps=reps, N=int(arrs[1].shape[0]),
                E2=int(arrs[1].shape[1]), width=width,
                max_n_ev=int(n_ev.max()), sum_n_ev=int(n_ev.sum()))
            if kernel == "wide":
                sms = torch.cuda.get_device_properties(dev) \
                    .multi_processor_count
                row["plan"] = l2_sweep.wide_plan(*arrs[1].shape, sp, sms)
                if label.startswith("long"):  # the new build at other L
                    row["ms_by_chunk"] = {}
                    for L in args.chunk_events:
                        kw = dict(chunk_events=L)
                        same = same and torch.equal(
                            call("new", kernel, arrs, sp, mode, **kw),
                            outs["new"])
                        row["ms_by_chunk"][L] = time_ms(
                            lambda: call("new", kernel, arrs, sp, mode, **kw),
                            dev, reps)
                    row["equal"] = same
                    if args.profile:
                        row["kernel_ms"] = {
                            L or "default": kernel_ms(
                                lambda: call("new", kernel, arrs, sp, mode,
                                             chunk_events=L), dev, reps)
                            for L in [None, *args.chunk_events]}
            print(kernel, label, json.dumps(row), flush=True)
    print(json.dumps(results))
    return 0 if all(r["equal"] for rows in results.values()
                    for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
