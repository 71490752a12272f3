"""The U mapping qualities at realistic scale, on the host.

Counterpart of ``profiling/u_mapq_scale.py``: 200,000 reads x 5 locations
(1M mapping lines, seed 3; three direct locations and two indirect ones,
on the nodes ``77`` and ``78``, a read) through the vectorised
``compute_u_mapping_qualities`` (``engine/u.py``; fU.h:155-362, the U
pipeline's hot loop over every mapping line), and the scalar per-line
oracle ``_compute_u_mapping_qualities_scalar`` on the first 2000 reads,
extrapolated. The identity manager is the synthetic one of the JAX
package's U tests, copied here. It prints the JAX script's three lines,
then one JSON line with the timings, the card's name and power limit
(where a card is present; the loop itself runs on the host), and the
agreement of the two on every read the oracle timed (1e-12 absolute plus
1e-9 relative, the JAX script's check).

    python -m metamaps_tpu_torch.profiling.u_mapq_scale [n_reads]
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from ..engine.u import (ULocation, _compute_u_mapping_qualities_scalar,
                        compute_u_mapping_qualities)
from ..engine.u_helper import (IdentityManager, IdentityReadLengthHistogram,
                               TreeAdjustedIdentities)
from . import bench

N_READS = 200_000
SEED = 3
SCALAR_READS = 2000  # reads the scalar oracle is timed on
K = 16
ABS_TOL, REL_TOL = 1e-12, 1e-9


def _synthetic_identity_manager() -> IdentityManager:
    """Identities peaked at 92 % for the direct locations, and per read
    length a histogram over 84-96 % for the indirect nodes ``77`` and
    ``78`` (``tests/test_u_pipeline.py:_synthetic_identity_manager``)."""
    ih = IdentityReadLengthHistogram()
    ih.minimum_identity = 75
    ih.maximum_identity = 100
    raw = {i: 0.5 ** abs(92 - i) for i in range(75, 101)}
    tot = sum(raw.values())
    ih.identity_histogram = {i: v / tot for i, v in raw.items()}
    ih.read_length_histogram = {5000: 1.0}

    tai = TreeAdjustedIdentities()
    for node in ("77", "78"):
        for rl in (2000, 5000, 20000):
            ps = {84: 0.1, 88: 0.25, 92: 0.4, 96: 0.25}
            tot = sum(ps.values())
            tai.D.setdefault(node, {})[rl] = {k: v / tot
                                              for k, v in ps.items()}
    return IdentityManager(ih, tai)


def make_reads(n_reads: int, rng):
    """Per read of 2500-20,000 bp: three direct locations (taxa 1000-1002)
    and two indirect ones (nodes 77, 78, at 0.92 of the drawn identity),
    each with a sketch of 80-400 and a shared count drawn as the k-mer
    survival model predicts."""
    def plausible(ident, sketch):
        p_surv = ident ** 16
        p = p_surv / (2 - p_surv)
        return int(np.clip(rng.binomial(sketch, p), 1, sketch))

    reads = []
    for ri in range(n_reads):
        rl = int(rng.integers(2500, 20000))
        locs = []
        for d in range(3):
            sketch = int(rng.integers(80, 400))
            ident = float(rng.uniform(0.80, 0.98))
            locs.append(ULocation(f"r{ri}", str(1000 + d), ident, sketch,
                                  plausible(ident, sketch), rl, 0.0, 0.0,
                                  True))
        for node in ("77", "78"):
            sketch = int(rng.integers(80, 400))
            ident = float(rng.uniform(0.80, 0.98))
            locs.append(ULocation(f"r{ri}", node, ident, sketch,
                                  plausible(0.92 * ident, sketch), rl, 0.0,
                                  0.0, False))
        reads.append(locs)
    return reads


def max_disagreement(scalar, vectorised) -> tuple:
    """(max |a - b| over every location, whether each lies within
    ``ABS_TOL + REL_TOL |a|``) of two runs' mapping qualities."""
    worst, ok = 0.0, True
    for sa, va in zip(scalar, vectorised, strict=True):
        for a, b in zip(sa, va, strict=True):
            d = abs(a.mapq - b.mapq)
            worst = max(worst, d)
            ok = ok and d <= ABS_TOL + REL_TOL * abs(a.mapq)
    return worst, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_reads", type=int, nargs="?", default=N_READS)
    args = ap.parse_args(argv)
    n_reads = args.n_reads
    rng = np.random.default_rng(SEED)
    print(f"synthesizing {n_reads} reads x 5 locations = "
          f"{5 * n_reads} mapping lines ...", flush=True)
    reads = make_reads(n_reads, rng)
    im = _synthetic_identity_manager()

    n_scalar = min(SCALAR_READS, n_reads)
    scalar = [copy.deepcopy(locs) for locs in reads[:n_scalar]]
    t0 = time.perf_counter()
    for locs in scalar:
        _compute_u_mapping_qualities_scalar(locs, im, K)
    t_scalar = time.perf_counter() - t0
    per_read_scalar = t_scalar / n_scalar

    compute_u_mapping_qualities(copy.deepcopy(reads[0]), im, K)  # warm
    t0 = time.perf_counter()
    for locs in reads:
        compute_u_mapping_qualities(locs, im, K)
    t_vec = time.perf_counter() - t0
    per_read_vec = t_vec / n_reads
    worst, agree = max_disagreement(scalar, reads[:n_scalar])

    print(f"scalar oracle : {per_read_scalar * 1e3:.3f} ms/read "
          f"({n_scalar} reads timed); {5 * n_reads} lines would take "
          f"{per_read_scalar * n_reads / 60:.1f} min")
    print(f"vectorized    : {per_read_vec * 1e3:.3f} ms/read; "
          f"{5 * n_reads} lines in {t_vec:.1f} s")
    print(f"speedup       : {per_read_scalar / per_read_vec:.1f}x")
    card = (bench.card_name(torch.device("cuda"))
            if torch.cuda.is_available() else None)
    print(json.dumps({
        "reads": n_reads, "mapping_lines": 5 * n_reads, "seed": SEED,
        "runs_on": "host", "card": card,
        "scalar_reads": n_scalar, "scalar_s": t_scalar,
        "scalar_ms_per_read": per_read_scalar * 1e3,
        "vectorised_s": t_vec, "vectorised_ms_per_read": per_read_vec * 1e3,
        "speedup": per_read_scalar / per_read_vec,
        "max_abs_diff": worst, "agree": agree,
        "tolerance": {"abs": ABS_TOL, "rel": REL_TOL}}), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
