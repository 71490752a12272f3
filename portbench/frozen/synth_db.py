"""ONT-like read generator: substitutions, insertions and deletions on a
slice of a genome.

Frozen copy of ``ont_read`` of ``metamaps_tpu_torch/sim/synth_db.py``: the
benchmark's inputs must not move when the program's copy does, so the same
seed gives the same reads in every later check.
"""
from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def ont_read(rng, genome: np.ndarray, length: int, sub: float = 0.06,
             ins: float = 0.025, dele: float = 0.025) -> np.ndarray:
    """One ONT-like read: slice + substitutions + insertions + deletions
    (the PBSIM CLR regime simulate.pl:41-57 approximates: ~0.88 accuracy)."""
    pos = int(rng.integers(0, len(genome) - length))
    r = genome[pos : pos + length]
    keep = rng.random(length) >= dele
    r = r[keep]
    reps = 1 + (rng.random(len(r)) < ins).astype(np.int64)
    r = np.repeat(r, reps)
    m = rng.random(len(r)) < sub
    r = r.copy()
    r[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return r
