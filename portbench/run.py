"""The benchmark of metamaps_tpu_torch: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration and a traffic mix; the mix names its driver. The run
sets the cell up (its data from the configuration's set-up and the seed,
the program's index and engine, a warm-up of every shape the traffic
uses), measures for ``--seconds``, reads the per-layer metrics where
``--trace 1``, checks what the timed calls wrote against the plain
reference, and prints one JSON line as the last line of standard output.
It runs on the CUDA card only: without one it exits with 2 and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout, should torch or
    Triton build anything (the program's nvcc and g++ builds already go to
    ``build/metamaps_tpu_torch``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv=None, device=None, root: Path = None) -> int:
    """One run. ``device`` None asks for the card (exit 2 without enough of
    them); a test passes ``"cpu"`` to drive the rest of a run on the host
    at a tiny size, and ``root``, a checkout of its own."""
    args = parse_args(argv)
    root = Path(root or ROOT)
    _cache_dirs(root)
    from portbench import core

    cell = core.resolve(root, args.workload)
    import torch

    torch.set_num_threads(core.HOST_THREADS)

    if device is None:
        if not torch.cuda.is_available():
            core.log("no CUDA device: the benchmark runs on the card only")
            return 2
        if torch.cuda.device_count() < cell.chips:
            core.log(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} visible")
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    ctx = core.Context(root=root, cell=cell, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=dev, workdir=workdir, t_start=T_START)
    try:
        return _run(ctx, core, torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(ctx, core, torch) -> int:
    cell = ctx.cell
    setup_mod = core.load_piece(ctx.root, "setups", cell.config_name)
    driver = core.load_piece(ctx.root, "drivers", cell.traffic["kind"])
    state = driver.setup(ctx, setup_mod)
    ctx.record["setup_s"] = time.perf_counter() - ctx.t_start
    core.log(f"set-up {ctx.record['setup_s']:.2f} s")
    driver.window(ctx, state)
    if ctx.trace:
        driver.traced(ctx, state)
    if ctx.on_card:
        torch.cuda.synchronize(ctx.device)
        ctx.record["peak_bytes"] = int(torch.cuda.max_memory_allocated(ctx.device))
    wanted = cell.per_layer if ctx.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = core.load_piece(ctx.root, "metrics", m["name"]).read(ctx, state)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted, failed = driver.counts(ctx, state)
    checks = driver.check(ctx, state)  # frees the program's state first
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    leaked = core.forbidden_loaded()
    if leaked:
        core.log(f"JAX or the JAX package was loaded: {leaked}")
        return 3
    device_rec = {
        "platform": "gpu" if ctx.on_card else "cpu",
        "kind": (torch.cuda.get_device_name(ctx.device) if ctx.on_card
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(ctx.record.get("peak_bytes", 0)),
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if ctx.trace:
        tr = ctx.record.get("trace")
        device_rec["busy_s"] = tr["busy_s"] if tr else 0.0
        device_rec["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
