"""What every cell of the benchmark shares: the cell's context, spans, the
lookup of a piece by its name, and the reading of a profiler trace.

A piece is found by its name under the checkout's ``portbench/``:
``configs/<config>.json``, ``traffic/<mix>.json``, ``setups/<config>.py``,
``drivers/<kind>.py`` (``kind`` named in the mix) and
``metrics/<metric>.py``. Code pieces are loaded from their files, so a
later cell, mix, configuration or metric is a new file and a new entry in
``BENCHMARK.json``, and no file here changes.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metamaps_tpu")
TRACE_PREFIX = "portbench."
#: host threads of a run (torch's pool, the index build's winnowing, the
#: reference's workers), fixed so that a run does the same on any host
HOST_THREADS = 8


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_piece(root: Path, kind: str, name: str):
    """The module of ``portbench/<kind>/<name>.py`` under ``root``."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} piece {name!r}: {path}")
    mod_name = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` resolved to its pieces."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _lists(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric belongs to a cell: its ``workloads`` name the cell,
    or it has none and (for a per-layer metric) the cell reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def resolve(root: Path, cell_name: str) -> Cell:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"one of {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _lists(m, cell_name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _lists(m, cell_name, names)]
    return Cell(cell_name, int(w["chips"]), w["config"], config,
                w["traffic"], traffic, e2e, per_layer)


@dataclass
class Context:
    """One run of one cell. Drivers fill ``record`` with what they measured
    (the metric readers read it) and ``spans`` with the benchmark's own
    spans around the program's calls."""

    root: Path
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    workdir: Path
    t_start: float  # perf_counter at process start
    record: Dict[str, object] = field(default_factory=dict)
    spans: List[tuple] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def span_s(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)

    @property
    def on_card(self) -> bool:
        return getattr(self.device, "type", "cpu") == "cuda"


def log(msg: str) -> None:
    print(f"# portbench: {msg}", file=sys.stderr, flush=True)


def card_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (a card
    set below its maximum runs slower under load)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (no nvidia-smi)"


def forbidden_loaded() -> List[str]:
    """Modules of JAX or the JAX package that this process holds, compared
    by whole top-level name (``metamaps_tpu_torch`` is not
    ``metamaps_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# profiler traces
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost(events):
    """(starts, ends, names) of the events that no other covers, in time
    order (disjoint, so a time falls in at most one)."""
    starts, ends, names = [], [], []
    for e in sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if ends and a < ends[-1]:
            continue
        starts.append(a)
        ends.append(b)
        names.append(str(e["name"]))
    return starts, ends, names


def _covering(top, t) -> Optional[str]:
    starts, ends, names = top
    i = bisect.bisect_right(starts, t) - 1
    return names[i] if i >= 0 and t <= ends[i] else None


def read_trace(path: str) -> Optional[dict]:
    """Device busy time, window, the device operations that took most time
    and the idle gaps by what the host was doing, from a chrome trace that
    ``torch.profiler`` exported, over the span of the benchmark's
    ``portbench.*`` annotations. None where the trace holds no device
    operation."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(TRACE_PREFIX)]
    if not dev or not marks:
        return None
    w0 = min(float(e["ts"]) for e in marks)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    busy = _merge((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                  for e in dev if float(e["ts"]) < w1
                  and float(e["ts"]) + float(e["dur"]) > w0)
    busy = [iv for iv in busy if iv[1] > iv[0]]
    busy_us = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    top_marks = _outermost(marks)
    top_ops = _outermost([e for e in events if e.get("cat") == "cpu_op"])

    def doing(t):
        """The benchmark annotation and the outermost program operation
        that cover host time ``t``."""
        return (f"{_covering(top_marks, t) or 'outside'}:"
                f"{_covering(top_ops, t) or 'python'}")

    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            key = doing((a + b) / 2)
            gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "by_op": by_op,
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


@contextlib.contextmanager
def profiled(ctx: Context, key: str):
    """Trace the block with ``torch.profiler`` on the card and put
    :func:`read_trace`'s summary under ``ctx.record[key]``; on the CPU the
    block runs untraced (no device metric comes from a CPU run)."""
    if not ctx.on_card:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = ctx.workdir / f"trace_{key}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    ctx.record[key] = read_trace(str(path))
    os.remove(path)
    log(f"trace {key} read in {time.perf_counter() - t0:.1f} s")


def record_function(name: str):
    """A ``portbench.<name>`` annotation in the profiler's trace."""
    from torch.profiler import record_function as rf

    return rf(TRACE_PREFIX + name)
