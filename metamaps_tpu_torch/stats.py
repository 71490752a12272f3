"""Sketch statistics: Jaccard <-> mash distance, CI bounds, p-values.

Host-side parity implementations of the reference's Stat namespace
(src/map/include/map_stats.hpp):

- j2md / md2j                 (map_stats.hpp:44,62)
- md_lower_bound              (map_stats.hpp:79, boost inverse binomial)
- estimate_minimum_hits[_relaxed]  (map_stats.hpp:120,142)
- estimate_pvalue             (map_stats.hpp:179)
- recommended_window_size     (map_stats.hpp:226)
- likelihood_observed_set_sizes    (mapWrap.h:332, the mapQ binomial model)
  and its batch over many mapping lines

The reference computes in C++ ``float`` with double-precision intermediates;
we reproduce the float32 narrowing points exactly (they decide acceptance at
the identity cutoff boundary).

Boost's ``quantile(complement(binomial(s, p), q))`` with the default
``integer_round_outwards`` discrete-quantile policy solves the continuized
survival function I_p(x+1, s-x) = q for real x and rounds up (clamped to
[0, s]); :func:`binom_quantile_complement` mirrors that via scipy's
incomplete beta.

Counterpart: ``metamaps_tpu/stats.py``, copied so that the port imports
nothing of the JAX package; :func:`likelihood_observed_set_sizes_batch`
is the port's own.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import special as sps
from scipy import optimize as spo
from scipy import stats as spstats

_f32 = np.float32


def j2md(j: float, k: int) -> float:
    """Jaccard estimate -> mash distance (float32 result)."""
    j = _f32(j)
    if j == 0:
        return float(_f32(1.0))
    if j == 1:
        return float(_f32(0.0))
    md = (-1.0 / k) * math.log(2.0 * float(j) / (1.0 + float(j)))
    return float(_f32(md))


def md2j(d: float, k: int) -> float:
    """Mash distance -> jaccard estimate (float32 result; k*d multiplied in
    float32 first, as in the C++)."""
    kd = _f32(k) * _f32(d)
    jac = 1.0 / (2.0 * math.exp(float(kd)) - 1.0)
    return float(_f32(jac))


def binom_quantile_complement(s: int, p: float, q: float) -> int:
    """Smallest-order statistic x with continuized P(X > x) = q, rounded up.

    Mirrors boost quantile(complement(binomial(s, p), q)) under the default
    integer_round_outwards policy. Continuous extension of the binomial CDF:
    cdf(x) = I_{p}(x+1, s-x) complement, i.e. sf(x) = I_p(x+1, s-x). Since
    sf is decreasing in x and the result is the ceiling of the continuous
    solution, it equals the smallest integer n with sf(n) <= q (or s when
    none exists below s) — computed by integer bisection, ~log2(s) betainc
    evaluations instead of a brentq root-find."""
    return int(binom_quantile_complement_vec(np.asarray([s]), np.asarray([p]), q)[0])


def binom_quantile_complement_vec(s, p, q: float):
    """Vectorized :func:`binom_quantile_complement` over arrays s, p."""
    s = np.asarray(s, np.int64)
    p = np.asarray(p, np.float64)
    s_b, p_b = np.broadcast_arrays(s, p)
    s_b = s_b.astype(np.int64)
    searchable = (p_b > 0) & (p_b < 1) & (s_b > 0)
    s_safe = np.maximum(s_b, 1)
    p_safe = np.where(searchable, p_b, 0.5)

    # smallest n in [0, s-1] with I_p(n+1, s-n) <= q, else s
    lo = np.zeros_like(s_b)
    hi = s_b.copy()
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        sf = sps.betainc(mid + 1.0, np.maximum(s_safe - mid, 1), p_safe)
        cond = sf <= q
        hi = np.where(active & cond, mid, hi)
        lo = np.where(active & ~cond, mid + 1, lo)
    out = lo
    out = np.where(p_b <= 0, 0, out)
    out = np.where(p_b >= 1, s_b, out)
    return out


def md_lower_bound(d: float, s: int, k: int, ci: float) -> float:
    """Lower bound on mash distance within the given confidence interval
    (reference map_stats.hpp:79-111, boost branch)."""
    q2 = (1.0 - float(_f32(ci))) / 2.0
    x = binom_quantile_complement(s, md2j(d, k), q2)
    jaccard = float(_f32(_f32(x) / _f32(s)))
    return j2md(jaccard, k)


# --- vectorized float32-exact variants (same narrowing points) -------------


def j2md_vec(j, k: int):
    """Vector j2md: float32 in/out, float64 log intermediate."""
    jf = np.asarray(j, np.float32)
    j64 = jf.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        md = ((-1.0 / k) * np.log(2.0 * j64 / (1.0 + j64))).astype(np.float32)
    md = np.where(jf == 0, np.float32(1.0), md)
    md = np.where(jf == 1, np.float32(0.0), md)
    return md


def md2j_vec(d, k: int):
    """Vector md2j: k*d multiplied in float32 first, as in the C++."""
    kd = np.float32(k) * np.asarray(d, np.float32)
    jac = 1.0 / (2.0 * np.exp(kd.astype(np.float64)) - 1.0)
    return jac.astype(np.float32)


def md_lower_bound_vec(d, s, k: int, ci: float):
    q2 = (1.0 - float(_f32(ci))) / 2.0
    x = binom_quantile_complement_vec(s, md2j_vec(d, k).astype(np.float64), q2)
    jaccard = x.astype(np.float32) / np.asarray(s, np.float32)
    return j2md_vec(jaccard, k)


def acceptance_vec(shared, s, k: int, pi: float):
    """Vectorized doL2Mapping acceptance (computeMap.hpp:404-415): returns
    (nucIdentity f32, nucIdentityUpperBound f32, accepted bool) arrays.
    Entries with s == 0 are marked not accepted."""
    shared = np.asarray(shared, np.int64)
    s = np.asarray(s, np.int64)
    s_safe = np.maximum(s, 1)
    jac = shared.astype(np.float32) / s_safe.astype(np.float32)
    mash = j2md_vec(jac, k)
    mash_lb = md_lower_bound_vec(mash, s_safe, k, 0.9)
    nuc = (np.float32(100) * (np.float32(1) - mash)).astype(np.float32)
    ub = (np.float32(100) * (np.float32(1) - mash_lb)).astype(np.float32)
    ok = (ub.astype(np.float64) >= pi) & (s > 0)
    return nuc, ub, ok


def estimate_minimum_hits(s: int, k: int, perc_identity: float) -> int:
    mash_dist = _f32(1.0 - float(perc_identity) / 100.0)
    jaccard = md2j(mash_dist, k)
    return int(math.ceil(1.0 * s * jaccard))


def estimate_minimum_hits_relaxed(s: int, k: int, perc_identity: float) -> int:
    start = estimate_minimum_hits(s, k, perc_identity)
    relaxed = start
    for i in range(start, -1, -1):
        jaccard = _f32(1.0 * i / s)
        d = j2md(jaccard, k)
        d_lower = md_lower_bound(d, s, k, 0.9)
        id_upper = 100.0 * (1.0 - d_lower)
        if id_upper >= perc_identity:
            relaxed = i
        else:
            break
    return relaxed


def estimate_pvalue(
    s: int,
    k: int,
    alphabet_size: int,
    identity: float,
    length_query: int,
    length_reference: int,
) -> float:
    kmer_space = float(alphabet_size) ** k
    px = py = 1.0 / (1.0 + kmer_space / length_query)
    r = px * py / (px + py - px * py)
    x = estimate_minimum_hits_relaxed(s, k, identity)
    if x == 0:
        cdf_complement = 1.0
    else:
        cdf_complement = float(spstats.binom.sf(x - 1, s, r))
    return length_reference * cdf_complement


def recommended_window_size(
    pvalue_cutoff: float,
    k: int,
    alphabet_size: int,
    identity: float,
    length_query: int,
    length_reference: int,
) -> int:
    potential = [1, 2, 5] + list(range(10, length_query, 10))
    optimal_sketch = None
    for e in potential:
        if estimate_pvalue(e, k, alphabet_size, identity, length_query, length_reference) <= pvalue_cutoff:
            optimal_sketch = e
            break
    if optimal_sketch is None:
        raise ValueError("no sketch size satisfies the p-value cutoff")
    w = int(2.0 * length_query / optimal_sketch)
    return min(max(w, 1), length_query)


def likelihood_observed_set_sizes(
    k: int, n_kmers: int, identity: float, sketch_size: int, intersection_size: int
) -> float:
    """P(intersection | sketch, identity): binomial pdf with expected set
    sizes under the k-mer survival model (reference mapWrap.h:332-356)."""
    assert intersection_size <= sketch_size
    p_survival = identity ** k
    e_surviving = p_survival * n_kmers
    e_surviving_int = float(np.round(e_surviving))
    e_union = n_kmers + (n_kmers - e_surviving_int)
    e_intersection = e_surviving_int
    return float(spstats.binom.pmf(intersection_size, sketch_size, e_intersection / e_union))


def likelihood_observed_set_sizes_batch(
    k: int, n_kmers, identity, sketch_size, intersection_size
) -> list:
    """:func:`likelihood_observed_set_sizes` of each element of equally long
    sequences, as a list of Python floats, bit-equal to the scalar calls.
    ``identity ** k * n_kmers`` is taken element by element in Python
    scalar arithmetic, because numpy's SIMD ``power`` can differ from
    ``**`` in the last bit. The rest runs on arrays: rounding, the sums
    and the division are correctly rounded IEEE operations there too, and
    one public ``binom.pmf`` call applies its argument checks, Boost pmf
    loop and clip element by element as on a scalar."""
    n = np.asarray(n_kmers, np.float64)
    e_surviving = np.round(np.array(
        [e ** k * m for m, e in zip(n_kmers, identity)], np.float64))
    p = e_surviving / (n + (n - e_surviving))
    return spstats.binom.pmf(np.asarray(intersection_size),
                             np.asarray(sketch_size), p).tolist()


def likelihood_observed_set_sizes_vec(
    k: int, n_kmers, identity, sketch_size, intersection_size
):
    """Vectorized :func:`likelihood_observed_set_sizes`: every argument
    broadcasts. Not bit-equal to the scalar calls: numpy's SIMD ``power``
    can differ from ``**`` in the last bit, so the two agree exactly only
    where that bit does not move the integer rounding of the expected
    surviving k-mers (after it, the division and the binomial pmf kernel
    are the same); :func:`likelihood_observed_set_sizes_batch` is bit-equal.
    Calls scipy's raw ``binom._pmf`` directly: the public
    wrapper's arg masking is only needed for out-of-support inputs, which
    this model never produces (0 <= intersection <= sketch, 0 < p <= 1),
    and it costs ~10x the pmf evaluation itself."""
    identity = np.asarray(identity, np.float64)
    p_survival = identity ** k
    e_surviving = np.round(p_survival * np.asarray(n_kmers, np.float64))
    e_union = n_kmers + (n_kmers - e_surviving)
    p = e_surviving / e_union
    out = spstats.binom._pmf(
        *np.broadcast_arrays(
            np.asarray(intersection_size, np.float64),
            np.asarray(sketch_size, np.float64), p,
        )
    )
    return np.asarray(out, np.float64)
