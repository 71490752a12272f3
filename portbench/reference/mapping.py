"""The plain reference of the mapping cells: the unified, mapQ-annotated
lines that MetaMaps writes for a read against one shard, worked out from
the genomes and the reads alone.

It is written from MetaMaps' algorithm and shares no code with the
program: MurmurHash3_x64_128 of every k-mer (seed 42, the low 32 bits of
h1) and the winnowed minimizers of ``addMinimizers`` (commonFunc.hpp),
the frequency threshold of ``computeFreqHist`` (winSketch.hpp), L1
candidate regions, the L2 super-window, acceptance, strand votes and the
report filter (computeMap.hpp, slidingMap.hpp, MIIteratorL2.hpp,
map_stats.hpp), and the mapping qualities of ``addMappingQualities``
(mapWrap.h). Where the program computes L2 by sweeps over events, this
scores every state of the super-window by set arithmetic on its hashes.
The index is derived on the device in plain PyTorch; each read is mapped
in NumPy on the host.
"""
from __future__ import annotations

import math
import multiprocessing
from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy import special, stats

INT_MAX = 2**31 - 1
SEED = 42
NO_HASH = 1 << 32  # above every 32-bit hash: a k-mer that is never a minimum


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 that holds the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


C1 = _signed(0x87C37B91114253D5)
C2 = _signed(0x4CF5AD432745937F)
F1 = _signed(0xFF51AFD7ED558CCD)
F2 = _signed(0xC4CEB9FE1A85EC53)


# ---------------------------------------------------------------------------
# MurmurHash3_x64_128 on int64 tensors (two's complement wraps as uint64)
# ---------------------------------------------------------------------------

def _shr(x, r: int):
    """Logical right shift of 64-bit lanes."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x, r: int):
    return (x * (1 << r)) | _shr(x, 64 - r)


def _fmix(x):
    x = x ^ _shr(x, 33)
    x = x * F1
    x = x ^ _shr(x, 33)
    x = x * F2
    return x ^ _shr(x, 33)


def _word(seq, start: int, nbytes: int, n: int):
    """Per k-mer position i < n, the little-endian word of bytes
    ``seq[i + start : i + start + nbytes]``."""
    out = torch.zeros(n, dtype=torch.int64, device=seq.device)
    for b in range(nbytes):
        out = out | (seq[start + b:start + b + n].to(torch.int64) << (8 * b))
    return out


def murmur_kmers(seq, k: int):
    """Low 32 bits of h1 of MurmurHash3_x64_128(k-mer bytes, seed 42) for
    every k-mer of the uint8 tensor ``seq``, as int64."""
    n = seq.numel() - k + 1
    h1 = torch.full((n,), SEED, dtype=torch.int64, device=seq.device)
    h2 = h1.clone()
    for blk in range(k // 16):
        k1 = _word(seq, 16 * blk, 8, n)
        k2 = _word(seq, 16 * blk + 8, 8, n)
        h1 = h1 ^ (_rotl(k1 * C1, 31) * C2)
        h1 = (_rotl(h1, 27) + h2) * 5 + 0x52DCE729
        h2 = h2 ^ (_rotl(k2 * C2, 33) * C1)
        h2 = (_rotl(h2, 31) + h1) * 5 + 0x38495AB5
    rem, tail = k % 16, 16 * (k // 16)
    if rem > 8:
        h2 = h2 ^ (_rotl(_word(seq, tail + 8, rem - 8, n) * C2, 33) * C1)
    if rem > 0:
        h1 = h1 ^ (_rotl(_word(seq, tail, min(rem, 8), n) * C1, 31) * C2)
    h1, h2 = h1 ^ k, h2 ^ k
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1) + _fmix(h2)
    return h1 & 0xFFFFFFFF


_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32
_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _x, _y in ("AT", "TA", "CG", "GC"):
    _COMPLEMENT[ord(_x)] = ord(_y)


def minimizers(seq: np.ndarray, k: int, w: int, device="cpu"):
    """addMinimizers: (hash int64, wpos int64, strand int8) numpy arrays of
    one sequence. A k-mer's hash is the smaller of its two strands' (a
    k-mer equal to its reverse complement is skipped); window ``j`` holds
    k-mers ``j .. j+w-1``, is looked at only where its last k-mer counts,
    and picks the rightmost of its smallest hashes; a record is written at
    the first window of each run of one pick. Where the first record is at
    window 0, the runs right after it that repeat its hash and strand are
    not written."""
    n = len(seq) - k + 1
    nw = n - w + 1
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int8))
    if n <= 0 or nw <= 0:
        return empty
    up = _UPPER[seq]
    fwd = murmur_kmers(torch.from_numpy(up).to(device), k)
    rc = np.ascontiguousarray(_COMPLEMENT[up][::-1])
    bwd = murmur_kmers(torch.from_numpy(rc).to(device), k).flip(0)
    counted = fwd != bwd
    canon = torch.minimum(fwd, bwd)
    strand = torch.where(fwd < bwd, 1, -1).to(torch.int8)
    key = torch.where(counted, canon, torch.full_like(canon, NO_HASH))
    del fwd, bwd
    low = key.unfold(0, w, 1).amin(1)
    pick = torch.full((nw,), -1, dtype=torch.int64, device=key.device)
    for d in range(w - 1, -1, -1):
        found = (key[d:d + nw] == low) & (pick < 0)
        pick = torch.where(found, torch.arange(d, d + nw, device=key.device), pick)
    looked = torch.nonzero(counted[w - 1:] & (low < NO_HASH)).flatten()
    if looked.numel() == 0:
        return empty
    p = pick[looked]
    first = torch.ones_like(p, dtype=torch.bool)
    first[1:] = p[1:] != p[:-1]
    wpos = looked[first].cpu().numpy()
    at = p[first]
    h = canon[at].cpu().numpy()
    s = strand[at].cpu().numpy()
    if wpos.size > 1 and wpos[0] == 0:
        j = 1
        while j < wpos.size and h[j] == h[0] and s[j] == s[0]:
            j += 1
        keep = np.r_[0, np.arange(j, wpos.size)]
        h, wpos, s = h[keep], wpos[keep], s[keep]
    return h, wpos, s


# ---------------------------------------------------------------------------
# statistics (map_stats.hpp): float32 where MetaMaps holds a float
# ---------------------------------------------------------------------------

f32 = np.float32


def jaccard_to_mash(j, k: int) -> np.float32:
    j = f32(j)
    if j == 0:
        return f32(1.0)
    if j == 1:
        return f32(0.0)
    return f32(-1.0 / k * math.log(2.0 * float(j) / (1.0 + float(j))))


def mash_to_jaccard(d, k: int) -> np.float32:
    kd = f32(k) * f32(d)
    return f32(1.0 / (2.0 * math.exp(float(kd)) - 1.0))


def upper_quantile(s: int, p: float, q: float) -> int:
    """boost ``quantile(complement(binomial(s, p), q))``, rounded outwards:
    the least integer x whose continued survival function
    I_p(x + 1, s - x) is at most q, else s."""
    if p <= 0:
        return 0
    if p >= 1:
        return s
    x = np.arange(s)
    ok = np.flatnonzero(special.betainc(x + 1.0, s - x, p) <= q)
    return int(ok[0]) if ok.size else s


def mash_lower_bound(d, s: int, k: int, ci: float = 0.9) -> np.float32:
    q = (1.0 - float(f32(ci))) / 2.0
    x = upper_quantile(s, float(mash_to_jaccard(d, k)), q)
    return jaccard_to_mash(f32(f32(x) / f32(s)), k)


def minimum_hits(s: int, k: int, pi: float) -> int:
    """estimateMinimumHitsRelaxed: the fewest shared minimizers whose
    identity's upper bound still reaches ``pi``, counting down from the
    estimate at ``pi`` itself."""
    top = int(math.ceil(1.0 * s * float(mash_to_jaccard(f32(1.0 - pi / 100.0), k))))
    best = top
    for i in range(top, -1, -1):
        d = jaccard_to_mash(f32(1.0 * i / s), k)
        if 100.0 * (1.0 - float(mash_lower_bound(d, s, k))) < pi:
            break
        best = i
    return best


def identity_and_bound(shared: int, s: int, k: int, cast=np.float32):
    """(nucIdentity, its 90 % upper bound), narrowed to ``cast`` where
    MetaMaps holds a ``float``."""
    mash = jaccard_to_mash(f32(1.0 * shared / s), k)
    lower = mash_lower_bound(mash, s, k)
    one, hundred = cast(1), cast(100)
    return (float(cast(hundred * (one - cast(mash)))),
            float(cast(hundred * (one - cast(lower)))))


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

def frequency_threshold(counts: np.ndarray) -> int:
    """computeFreqHist: the least occurrence count c such that at most
    0.001 % of the distinct hashes occur c times or more (INT_MAX where
    none is)."""
    if counts.size == 0:
        return INT_MAX
    allowed = int(counts.size * 0.001 / 100)
    values, per = np.unique(counts, return_counts=True)
    at_least = np.cumsum(per[::-1])[::-1]  # distinct hashes seen >= values[i] times
    ok = values[at_least <= allowed]
    return int(ok.min()) if ok.size else INT_MAX


class Index:
    """Every contig's minimizers in position order (host arrays), their
    counts over the whole shard, and the frequency threshold."""

    def __init__(self, genomes: Sequence[np.ndarray], k: int, w: int, device):
        self.contigs = [minimizers(g, k, w, device) for g in genomes]
        every = torch.from_numpy(np.concatenate([c[0] for c in self.contigs]))
        hashes, counts = torch.unique(every.to(device), return_counts=True)
        self.hashes = hashes.cpu().numpy()
        self.counts = counts.cpu().numpy()
        self.threshold = frequency_threshold(self.counts)
        self.hit_hash = np.zeros(0, np.int64)
        self.hit_at = np.zeros((0, 2), np.int64)

    def count(self, h: np.ndarray) -> np.ndarray:
        i = np.minimum(np.searchsorted(self.hashes, h), self.hashes.size - 1)
        return np.where(self.hashes[i] == h, self.counts[i], 0)

    def prepare_hits(self, queries: np.ndarray) -> None:
        """Where the hashes of ``queries`` under the threshold occur:
        ``hit_hash`` and, row by row, ``hit_at`` (contig, wpos)."""
        q = np.unique(queries)
        q = q[(self.count(q) > 0) & (self.count(q) < self.threshold)]
        rows = [np.stack([h[at], np.full(at.size, ci), p[at]], 1)
                for ci, (h, p, _) in enumerate(self.contigs)
                for at in [np.flatnonzero(np.isin(h, q))]]
        rows = np.concatenate(rows) if rows else np.zeros((0, 3), np.int64)
        self.hit_hash, self.hit_at = rows[:, 0], rows[:, 1:]


# ---------------------------------------------------------------------------
# one read
# ---------------------------------------------------------------------------

def read_sketch(h: np.ndarray, s: np.ndarray):
    """The read's sketch: its distinct minimizer hashes, ascending, each
    with the strand of its first record."""
    q, first = np.unique(h, return_index=True)
    return q, s[first].astype(np.int64)


def l1_regions(index: Index, q: np.ndarray, read_len: int, m: int):
    """Candidate regions (contig, start, end): every run of ``m`` hits of
    one contig within a read length, merged where they overlap."""
    hits = index.hit_at[np.isin(index.hit_hash, q)]
    hits = hits[np.lexsort((hits[:, 1], hits[:, 0]))]
    m = max(1, m)
    if hits.shape[0] < m:
        return []
    a, b = hits[:hits.shape[0] - m + 1], hits[m - 1:]
    runs = np.flatnonzero((a[:, 0] == b[:, 0]) & (b[:, 1] - a[:, 1] < read_len))
    regions = []
    for i in runs:
        contig, lo, hi = int(a[i, 0]), max(0, int(b[i, 1]) - read_len + 1), int(a[i, 1])
        if regions and regions[-1][0] == contig and regions[-1][2] >= lo:
            regions[-1][2] = max(regions[-1][2], hi)
        else:
            regions.append([contig, lo, hi])
    return [tuple(r) for r in regions]


def _shared(q: np.ndarray, r: np.ndarray) -> int:
    """|bottom-s(Q ∪ R) ∩ Q ∩ R| with s = |Q|: the hashes both hold among
    the s smallest of their union."""
    bottom = np.union1d(q, r)[:q.size]
    return int(np.intersect1d(np.intersect1d(bottom, q, assume_unique=True),
                              r, assume_unique=True).size)


def l2_best(index: Index, q: np.ndarray, read_len: int, k: int, w: int,
            region):
    """The super-window of ``read_len - (w-1) - (k-1)`` positions slides
    along the region's minimizers; it holds the minimizer at or before its
    start and those before its end, and is scored each time that set
    changes, while the window's end lies before the region's end plus a
    read length. (shared, mean start of the first and last best windows,
    first best window's [begin, end) indices) or None where none shares a
    hash."""
    contig, lo, hi = region
    h, pos, _ = index.contigs[contig]
    span = read_len - (w - 1) - (k - 1)
    start = int(np.searchsorted(pos, lo))
    stop = int(np.searchsorted(pos, hi + read_len))
    x0 = int(pos[start])
    # the starts at which a minimizer leaves or enters the window
    xs = np.union1d(pos[start:stop],
                    pos[np.searchsorted(pos, x0 + span):stop] - span + 1)
    begs = np.searchsorted(pos, xs, side="right") - 1
    ends = np.searchsorted(pos, xs + span)
    live = ends < stop
    begs, ends = begs[live], ends[live]
    if begs.size == 0:
        return None
    scores = np.array([_shared(q, np.unique(h[b:e])) for b, e in zip(begs, ends)])
    best = int(scores.max())
    if best == 0:
        return None
    hit = np.flatnonzero(scores == best)
    i, j = hit[0], hit[-1]
    return best, (int(pos[begs[i]]) + int(pos[begs[j]])) // 2, int(begs[i]), int(ends[i])


def strand_of(index: Index, contig: int, q: np.ndarray, q_strand: np.ndarray,
              beg: int, end: int) -> int:
    """computeStatistics: the strand votes of the hashes that count as
    shared in the best window (a hash seen twice there votes with its last
    record's strand)."""
    h, _, s = index.contigs[contig]
    rh, rs = h[beg:end][::-1], s[beg:end][::-1].astype(np.int64)
    r, last = np.unique(rh, return_index=True)
    bottom = np.union1d(q, r)[:q.size]
    both = np.intersect1d(np.intersect1d(bottom, q), r)
    votes = int(np.sum(q_strand[np.searchsorted(q, both)]
                       * rs[last][np.searchsorted(r, both)]))
    return 1 if votes > 0 else -1


def map_one(index: Index, params: dict, names, lengths, name: str,
            sketch, read_len: int, cast=np.float32) -> List[str]:
    """The read's unified lines: L1, L2, acceptance, strand, the report
    filter, the 12 fields, then correctedIdentity and mappingQuality."""
    k, w = params["kmer_size"], params["window_size"]
    pi = float(params["percentage_identity"])
    q, q_strand = sketch
    s = int(q.size)
    if s == 0:
        return []
    found = []
    for region in l1_regions(index, q, read_len, minimum_hits(s, k, pi)):
        best = l2_best(index, q, read_len, k, w, region)
        shared, mid = (0, 0) if best is None else best[:2]
        ident, upper = identity_and_bound(shared, s, k, cast)
        if upper < pi:
            continue
        strand = -1 if best is None else strand_of(
            index, region[0], q, q_strand, best[2], best[3])
        found.append((region[0], mid, ident, shared, strand))
    if not params["report_all"] and found:
        top = max(f[2] for f in found)
        found = [f for f in found if f[2] >= top - 1.0]
    lines = [" ".join([name, str(read_len), "0", str(read_len - 1),
                       "+" if strand > 0 else "-", names[c], str(lengths[c]),
                       str(mid), str(mid + read_len - 1), "%.6g" % ident,
                       str(shared), str(s)])
             for c, mid, ident, shared, strand in found]
    return mapping_qualities(lines, k, cast)


def mapping_qualities(lines: List[str], k: int, cast=np.float32) -> List[str]:
    """addMappingQualities over one read's lines: each line's likelihood is
    the binomial probability of its shared count among its sketch, with the
    success rate of k-mers surviving at the read's best identity
    (e^-(1-best), as likelihood_observed_set_sizes models it); the quality
    is its share of the read's sum. The corrected identity is
    e^-(1-identity)."""
    if not lines:
        return lines
    fields = [ln.split(" ") for ln in lines]
    ident = np.array([float(f[9]) / 100.0 for f in fields])
    shared = np.array([int(f[10]) for f in fields])
    sketch = np.array([int(f[11]) for f in fields])
    n = int(fields[0][1]) - k + 1
    surviving = math.floor(math.exp(-(1.0 - ident.max())) ** k * n + 0.5)
    lik = stats.binom.pmf(shared, sketch, surviving / (n + (n - surviving)))
    quality = lik / lik.sum()
    return [ln + " %.6g %.6g" % (float(cast(cast(math.exp(-(1.0 - i))) * 100)), qv)
            for ln, i, qv in zip(lines, ident, quality)]


# ---------------------------------------------------------------------------
# many reads
# ---------------------------------------------------------------------------

_WORKER_JOB = None  # a worker process's job, set by _start


def _start(job) -> None:
    global _WORKER_JOB
    _WORKER_JOB = job


def _work(name: str) -> List[str]:
    return _map_named(_WORKER_JOB, name)


def _map_named(job, name: str) -> List[str]:
    index, params, names, lengths, sketches, read_lens, cast = job
    return map_one(index, params, names, lengths, name, sketches[name],
                   read_lens[name], cast)


def expected_lines(index: Index, params: dict, names: Sequence[str],
                   lengths: Sequence[int], reads: Dict[str, np.ndarray],
                   casts=(np.float32,), workers: int = 1,
                   device="cpu") -> List[Dict[str, List[str]]]:
    """Per precision in ``casts``, per read name, the unified lines the read
    should get (a read shorter than ``min_read_length`` gets none). The
    reads are sketched in this process and mapped in ``workers`` processes
    that touch no device."""
    k, w = params["kmer_size"], params["window_size"]
    todo = [n for n, seq in reads.items()
            if len(seq) >= max(k, w, int(params["min_read_length"]))]
    sketches = {}
    for n in todo:
        h, _, s = minimizers(reads[n], k, w, device)
        sketches[n] = read_sketch(h, s)
    index.prepare_hits(np.concatenate([sketches[n][0] for n in todo])
                       if todo else np.zeros(0, np.int64))
    read_lens = {n: len(reads[n]) for n in todo}
    out = []
    for cast in casts:
        job = (index, params, names, lengths, sketches, read_lens, cast)
        if workers > 1 and len(todo) > 1:
            # forked workers share the index without a copy and start at
            # once; they call NumPy and SciPy only, never PyTorch or the
            # device
            with multiprocessing.get_context("fork").Pool(
                    min(workers, len(todo)), initializer=_start,
                    initargs=(job,)) as pool:
                lines = pool.map(_work, todo, chunksize=1)
                pool.close()
                pool.join()
        else:
            lines = [_map_named(job, n) for n in todo]
        out.append(dict(zip(todo, lines)))
    return out


def bf16(x) -> np.float32:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as a float32:
    the control's precision."""
    bits = np.array(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)[()]
