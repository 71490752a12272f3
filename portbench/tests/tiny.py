"""A copy of the benchmark at a size the CPU runs in seconds, for the
harness's tests: the same pieces, with the configurations and mixes cut
down in their files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    for key, val in changes.items():
        if isinstance(val, dict):
            data[key].update(val)
        else:
            data[key] = val
    path.write_text(json.dumps(data, indent=1))


def tiny_root(dst: Path) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``portbench/`` at a tiny
    size."""
    dst = Path(dst)
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    pb = dst / "portbench"
    zymo = json.loads((pb / "configs" / "zymo.json").read_text())
    _edit(pb / "configs" / "zymo.json",
          genomes=[dict(g, mbp=g["mbp"] / 25) for g in zymo["genomes"]])
    for mix in ("ont_files", "ont_minknow4k"):
        _edit(pb / "traffic" / f"{mix}.json", reads_per_file=16, pool_files=3,
              sample_reads=8, sample_odd_reads=4, trace_files=2, warm_files=1)
    return dst


def context(root: Path, cell: str, seed: int, workdir: Path):
    """A run's context for calling a driver's pieces directly."""
    import time

    import torch

    from portbench import core

    return core.Context(root=root, cell=core.resolve(root, cell), seed=seed,
                        seconds=1.0, trace=False, device=torch.device("cpu"),
                        workdir=Path(workdir), t_start=time.perf_counter())


def run_cell(root: Path, cell: str, seed: int, trace: int = 0,
             seconds: float = 1.0):
    """Run ``cell`` on the CPU in this process; (exit code, last line of
    standard output as a dict or None, standard output)."""
    import contextlib
    import io

    from portbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)], device="cpu",
                     root=root)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, out.getvalue()
