"""One EM round on the card against the host round, on synthetic tables.

Counterpart of ``em_bench`` in ``bench.py`` (1M read-location lines, 250k
reads, 5k taxa) and ``profiling/em_scale.py`` (1M and 12M lines): the same
table layout, four lines per read, made from a seed. For each size it times
:func:`metamaps_tpu_torch.engine.em.make_em_iterate_torch`'s round on
``device`` (each round ends with its copy of f to the host, as ``run_em``
uses it) and the host float64 round ``em_iterate``, and checks that the two
agree (ll within 1e-12 relative, f within 1e-12 absolute); with
``--sharded-ranks R`` also the round of the sharded backend
(``parallel/mesh.py:make_em_iterate_sharded``) over R ranks of ``device``,
held to the host round with the same tolerances.

    python -m metamaps_tpu_torch.profiling.em_bench              # cuda:0
    python -m metamaps_tpu_torch.profiling.em_bench --lines 1000000
    python -m metamaps_tpu_torch.profiling.em_bench --sharded-ranks 4
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..engine.em import MappingTable, em_iterate, make_em_iterate_torch

SIZES = (1_000_000, 12_000_000)  # lines, as profiling/em_scale.py
LINES_PER_READ = 4
N_TAXA = 5000
SEED = 3


def synthetic_table(rng, n_lines: int, n_tax: int = N_TAXA) -> MappingTable:
    """``bench.py``'s EM table: reads of LINES_PER_READ lines each, taxa
    drawn uniformly, mapQ uniform in [0, 1), one location per line."""
    n_reads = n_lines // LINES_PER_READ
    n_lines = n_reads * LINES_PER_READ
    return MappingTable(
        lines=[], contig_of_line=[], read_ids=["r"] * n_reads,
        taxon_list=["t"] * n_tax,
        read_of_line=np.repeat(np.arange(n_reads), LINES_PER_READ),
        taxon_of_line=rng.integers(0, n_tax, n_lines).astype(np.int32),
        mapq=rng.random(n_lines), inv_locations=np.full(n_lines, 1e-6),
        identity=np.zeros(n_lines), start=np.zeros(n_lines, np.int64),
        stop=np.zeros(n_lines, np.int64), read_len=np.zeros(n_lines, np.int64),
    )


def round_ms(step, f, reps: int) -> float:
    """Mean wall milliseconds of one round after a warm-up round; each
    round returns host arrays, so it includes its device synchronisation."""
    step(f)
    t0 = time.perf_counter()
    for _ in range(reps):
        step(f)
    return (time.perf_counter() - t0) * 1e3 / reps


def _agreement(step, f, want, n_lines: int, what: str):
    """(ll relative, f absolute) difference of ``step``'s round from the
    host round ``want``; raises above 1e-12."""
    fd, lld = step(f)
    fh, llh = want
    ll_rel = abs(lld - llh) / abs(llh)
    f_abs = float(np.abs(fd - fh).max())
    if ll_rel > 1e-12 or f_abs > 1e-12:
        raise AssertionError(f"{what} EM round differs from the host at "
                             f"{n_lines} lines: ll {ll_rel}, f {f_abs}")
    return ll_rel, f_abs


def run(device, sizes=SIZES, reps: int = 5, log=print,
        sharded_ranks: int = 0) -> list:
    """Time the round on ``device`` and on the host at each table size, and
    with ``sharded_ranks`` > 0 the sharded round over that many ranks of
    ``device``; returns one dict per size."""
    from ..parallel.mesh import make_em_iterate_sharded

    device = torch.device(device)
    rng = np.random.default_rng(SEED)
    rows = []
    for n_lines in sizes:
        table = synthetic_table(rng, n_lines)
        f = np.full(len(table.taxon_list), 1.0 / len(table.taxon_list))
        want = em_iterate(table, f)
        step = make_em_iterate_torch(table, device)
        ll_rel, f_abs = _agreement(step, f, want, n_lines, "torch")
        row = dict(lines=len(table.read_of_line), reads=len(table.read_ids),
                   taxa=len(table.taxon_list), device=str(device),
                   round_ms=round_ms(step, f, reps),
                   host_round_ms=round_ms(lambda x: em_iterate(table, x), f,
                                          reps),
                   ll_rel_diff=ll_rel, f_max_abs_diff=f_abs)
        if sharded_ranks:
            sharded = make_em_iterate_sharded(table, [device] * sharded_ranks)
            ll_s, f_s = _agreement(sharded, f, want, n_lines, "sharded")
            row.update(sharded_ranks=sharded_ranks,
                       sharded_round_ms=round_ms(sharded, f, reps),
                       sharded_ll_rel_diff=ll_s, sharded_f_max_abs_diff=f_s)
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--lines", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sharded-ranks", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("em_bench: no CUDA device", file=sys.stderr)
        return 1
    run(device, args.lines, args.reps, sharded_ranks=args.sharded_ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
