"""The port's batched mapQ likelihoods against the JAX package's scalar.

``metamaps_tpu_torch.stats.likelihood_observed_set_sizes_batch`` gives the
likelihoods of a whole unify batch with one binomial pmf call; each must be
bit-equal to ``metamaps_tpu.stats.likelihood_observed_set_sizes`` of its
line, since the unified file's mapping qualities are written from them.
"""
import math

import numpy as np
import pytest

from metamaps_tpu import stats
from metamaps_tpu_torch import stats as torch_stats


def _half_boundary_draws(k=16):
    """(identity, n_kmers) whose ``identity ** k * n_kmers`` lies within one
    ulp of a whole number and a half, so that the rounding decides: the
    floats next to the k-th root of each of 3,000 seeded boundaries."""
    rng = np.random.default_rng(5)
    out = []
    for n_kmers in rng.integers(100, 60000, 3000):
        half = int(rng.integers(1, n_kmers // 2)) + 0.5
        x = (half / n_kmers) ** (1.0 / k)
        for near in (np.nextafter(x, 0.0), x, np.nextafter(x, 2.0)):
            if abs(float(near) ** k * n_kmers - half) <= math.ulp(half):
                out.append((float(near), int(n_kmers)))
    return out


def _mapq_draws(seed: int, n: int):
    """n seeded (identity, n_kmers, sketch, intersection) draws over the
    ranges mapping lines reach: identity e^-(1-u), u in [0.6, 1]."""
    rng = np.random.default_rng(seed)
    ident = np.exp(-(1 - rng.uniform(0.6, 1.0, n)))
    n_kmers = rng.integers(1, 60000, n)
    sketch = rng.integers(1, 3000, n)
    inter = (sketch * rng.uniform(0, 1, n) ** 3).astype(np.int64)
    return [(float(a), int(b), int(c), int(d))
            for a, b, c, d in zip(ident, n_kmers, sketch, inter)]


MAPQ_EDGES = {
    "p_one": [(1.0, 5000, 500, 500), (1.0, 5000, 500, 499), (1.0, 1, 1, 1)],
    "intersection_zero": [(0.9, 5000, 600, 0), (0.7, 100, 3000, 0)],
    "intersection_equals_sketch": [(0.95, 5000, 600, 600), (0.99, 9, 7, 7)],
    "sketch_one": [(0.9, 5000, 1, 0), (0.9, 5000, 1, 1), (0.5, 3, 1, 1)],
}


@pytest.mark.parametrize("draws", [f"seed{s}" for s in range(4)]
                         + sorted(MAPQ_EDGES) + ["half_boundary"])
def test_likelihood_batch_is_bit_equal_to_the_scalar(draws):
    """The port's batched mapQ likelihoods against the scalar model, bit
    for bit: 4 x 25,000 seeded draws, and the edges of the model."""
    k = 16
    if draws.startswith("seed"):
        cases = _mapq_draws(int(draws[4:]), 25_000)
    elif draws == "half_boundary":
        cases = []
        for ident, n_kmers in _half_boundary_draws(k):
            cases += [(ident, n_kmers, 500, 100), (ident, n_kmers, 40, 5)]
        # products on either side of x.5, rounded down and up
        frac = {i ** k * n - math.floor(i ** k * n) for i, n, _, _ in cases}
        assert min(frac) < 0.5 < max(frac) and len(cases) >= 100
    else:
        cases = MAPQ_EDGES[draws]
    ident, n_kmers, sketch, inter = (list(c) for c in zip(*cases))
    got = torch_stats.likelihood_observed_set_sizes_batch(
        k, n_kmers, ident, sketch, inter)
    want = [stats.likelihood_observed_set_sizes(k, n, i, s, x)
            for i, n, s, x in cases]
    assert all(type(g) is float for g in got)
    assert [g.hex() for g in got] == [w.hex() for w in want]
