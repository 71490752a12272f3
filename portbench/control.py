"""The controls of the cells' comparisons at the cells' own sizes: for each
seed, the reference in the next lower precision put in the program's
place, held to the reference as a run holds the program, beside each
number's limit. A control has to read above a limit.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3

It runs where the cell runs (the reference derives a mapping cell's index
on the card) and never in the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import core
from portbench.run import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = core.resolve(ROOT, args.workload)
    setup_mod = core.load_piece(ROOT, "setups", cell.config_name)
    driver = core.load_piece(ROOT, "drivers", cell.traffic["kind"])
    limits = cell.traffic["limits"]
    for seed in args.seeds:
        workdir = Path(tempfile.mkdtemp(prefix="portbench-control-"))
        try:
            ctx = core.Context(root=ROOT, cell=cell, seed=seed, seconds=0.0,
                               trace=False, device=torch.device(args.device),
                               workdir=workdir, t_start=time.perf_counter())
            readings = driver.control(ctx, setup_mod)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": {n: {"value": v, "limit": limits[n]}
                                       for n, v in readings},
                          "fails": any(v > limits[n] for n, v in readings)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
