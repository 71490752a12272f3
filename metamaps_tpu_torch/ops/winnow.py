"""Winnowed-minimizer extraction, bit-compatible with the reference.

Counterpart: ``metamaps_tpu/ops/winnow.py``, whose module docstring states
the reference semantics (commonFunc.hpp:91-175 ``addMinimizers``): canonical
k-mer hashes with symmetric k-mers skipped, a monotone deque in which the
RIGHTMOST of equal window minima wins, one record per run of the same
minimum, and the "wpos-0 chain" dedupe.

- :func:`winnow_oracle`, :func:`winnow_np` and :func:`winnow_fast` are
  jax-free copies of the JAX package's host implementations (the index
  build and the serial oracle use them);
- :func:`winnow_dense` is the torch version for a padded read batch: dense
  per-window arrays plus an emission mask, computed with a log-step
  windowed minimum over (hash, position) composite keys.

Records are (hash: uint32, wpos: int32, strand: int8 {+1,-1}).
"""
from __future__ import annotations

import numpy as np
import torch

from .murmur3 import hash_kmers, hash_kmers_np

UINT32_MAX = np.uint32(0xFFFFFFFF)

# byte LUTs ------------------------------------------------------------------

_UPPER_LUT = np.arange(256, dtype=np.uint8)
_UPPER_LUT[97:123] -= 32

_RC_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in [(ord("A"), ord("T")), (ord("C"), ord("G"))]:
    _RC_LUT[_a], _RC_LUT[_b] = _b, _a


def upper_np(seq: np.ndarray) -> np.ndarray:
    return _UPPER_LUT[seq]


def revcomp_np(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of an upper-cased uint8 sequence (A<->T, C<->G,
    other bytes unchanged — matches reference reverseComplement,
    commonFunc.hpp:38-55)."""
    return _RC_LUT[seq][::-1]


# ---------------------------------------------------------------------------
# canonical per-position hashes (shared by the host implementations)
# ---------------------------------------------------------------------------


def canonical_hashes_np(seq: np.ndarray, k: int, alphabet_size: int = 4):
    """Per k-mer position: (canonical hash, strand, valid) numpy arrays.

    ``valid`` is False for symmetric k-mers (skipped by the reference).
    """
    sequ = upper_np(seq)
    fwd = hash_kmers_np(sequ, k)
    if alphabet_size == 4:
        rc = revcomp_np(sequ)
        bwd = hash_kmers_np(rc, k)[::-1]
    else:
        bwd = np.full_like(fwd, UINT32_MAX)
    valid = fwd != bwd
    canon = np.minimum(fwd, bwd)
    strand = np.where(fwd < bwd, np.int8(1), np.int8(-1))
    return canon, strand, valid


# ---------------------------------------------------------------------------
# oracle: direct deque algorithm
# ---------------------------------------------------------------------------


def winnow_oracle(seq: np.ndarray, k: int, w: int, alphabet_size: int = 4):
    """Monotone-deque winnowing, the exact reference algorithm.

    Returns (hashes uint32[N], wpos int32[N], strand int8[N]).
    """
    from collections import deque

    n = len(seq) - k + 1
    out_h, out_p, out_s = [], [], []
    if n <= 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.int8))
    canon, strand, valid = canonical_hashes_np(seq, k, alphabet_size)

    Q = deque()  # entries: [hash, wpos(dummy 0), strand, kmer_pos]
    for i in range(n):
        if not valid[i]:
            continue
        wid = i - w + 1
        while Q and Q[0][3] <= i - w:
            Q.popleft()
        while Q and Q[-1][0] >= canon[i]:
            Q.pop()
        Q.append([int(canon[i]), 0, int(strand[i]), i])
        if wid >= 0:
            front = Q[0]
            last = (out_h[-1], out_p[-1], out_s[-1]) if out_h else None
            if last is None or (front[0], front[1], front[2]) != last:
                front[1] = wid
                out_h.append(front[0])
                out_p.append(front[1])
                out_s.append(front[2])
    return (
        np.array(out_h, np.uint32),
        np.array(out_p, np.int32),
        np.array(out_s, np.int8),
    )


# ---------------------------------------------------------------------------
# vectorized numpy
# ---------------------------------------------------------------------------


def _run_compress(m, keys, strands, evaluated, w):
    """Shared run-compression for the vectorized implementations (host side).

    m: [NW] winning k-mer position per window; keys/strands indexed by m;
    evaluated: [NW] mask of windows the reference actually evaluates.
    """
    ev_idx = np.flatnonzero(evaluated)
    if ev_idx.size == 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.int8))
    m_ev = m[ev_idx]
    new_run = np.ones(ev_idx.size, dtype=bool)
    new_run[1:] = m_ev[1:] != m_ev[:-1]
    run_starts = ev_idx[new_run]
    run_m = m_ev[new_run]
    h = keys[run_m].astype(np.uint32)
    p = run_starts.astype(np.int32)
    s = strands[run_m].astype(np.int8)

    # wpos-0 chain suppression (see module docstring): if the first emitted
    # record has wpos 0, subsequent runs whose (hash, strand) match it are
    # suppressed until a differing run is emitted.
    if p.size > 1 and p[0] == 0:
        keep = np.ones(p.size, dtype=bool)
        j = 1
        while j < p.size and h[j] == h[0] and s[j] == s[0]:
            keep[j] = False
            j += 1
        if not keep.all():
            h, p, s = h[keep], p[keep], s[keep]
    return h, p, s


def winnow_np(seq: np.ndarray, k: int, w: int, alphabet_size: int = 4):
    """Vectorized numpy winnowing; identical output to :func:`winnow_oracle`."""
    n = len(seq) - k + 1
    if n <= 0 or n - w + 1 <= 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.int8))
    canon, strand, valid = canonical_hashes_np(seq, k, alphabet_size)

    # invalid positions can never be window minima (they never enter the
    # deque); push them above every real hash.
    key = canon.astype(np.uint64)
    key[~valid] = np.uint64(1) << np.uint64(32)

    nw = n - w + 1
    win = np.lib.stride_tricks.sliding_window_view(key, w)  # [nw, w]
    rev_arg = np.argmin(win[:, ::-1], axis=1)  # first min of reversed = rightmost
    m = np.arange(nw) + (w - 1 - rev_arg)
    win_min = key[m]

    # windows are evaluated only when their last position is valid, and the
    # deque must be non-empty (some valid position in the window).
    evaluated = valid[w - 1:] & (win_min >> np.uint64(32) == 0)
    return _run_compress(m, canon, strand, evaluated, w)


def winnow_fast(seq: np.ndarray, k: int, w: int, alphabet_size: int = 4):
    """Fastest available host winnowing: the native C++ deque
    (native/winnow.cpp, bit-exact with :func:`winnow_oracle`) when the
    toolchain is available, :func:`winnow_np` otherwise."""
    from metamaps_tpu_torch.io.native import winnow_native

    out = winnow_native(seq, k, w, alphabet_size)
    if out is not None:
        return out
    return winnow_np(seq, k, w, alphabet_size)


# ---------------------------------------------------------------------------
# torch batch implementation
# ---------------------------------------------------------------------------

_POS_BITS = 24  # k-mer positions < 2^24 ride below the key in one int64
_U32_MAX = 0xFFFFFFFF
_A, _C, _G, _T = 65, 67, 71, 84


def _upper(seq: torch.Tensor) -> torch.Tensor:
    return torch.where((seq >= 97) & (seq < 123), seq - 32, seq)


def _complement(seq: torch.Tensor) -> torch.Tensor:
    out = seq.clone()
    out[seq == _A] = _T
    out[seq == _T] = _A
    out[seq == _C] = _G
    out[seq == _G] = _C
    return out


def _window_min(x: torch.Tensor, w: int) -> torch.Tensor:
    """Minimum over every window of w consecutive columns (log-step
    doubling: spans 1, 2, 4, ..., then two overlapping power-of-2 spans)."""
    nw = x.shape[-1] - w + 1
    cur, span = x, 1
    while span * 2 <= w:
        cur = torch.minimum(cur[..., :-span], cur[..., span:])
        span *= 2
    return torch.minimum(cur[..., :nw], cur[..., w - span: w - span + nw])


def winnow_dense(seq: torch.Tensor, n_kmers_valid: torch.Tensor, k: int,
                 w: int, alphabet_size: int = 4):
    """Dense winnowing of a right-padded read batch.

    ``seq`` uint8 ``[B, L]``; ``n_kmers_valid`` ``[B]`` (read length - k + 1)
    masks the padding. Returns per window ``[B, L-k+1-w+1]``: ``emit`` bool
    (the window's minimum starts a record, wpos-0 dedupe applied), ``hash``
    int64 (uint32 value of the window minimum), ``strand`` int8 and
    ``evaluated`` bool. Compacting ``emit`` in window order gives exactly
    :func:`winnow_oracle`'s records, with wpos = window index.

    The windowed RIGHTMOST argmin is a plain minimum over composite int64
    keys ``(invalid, hash, -position)``: invalid (symmetric or padding)
    positions sort above every valid one, and among equal hashes the larger
    position wins."""
    B, L = seq.shape
    n = L - k + 1
    if n - w + 1 <= 0:
        raise ValueError("padded read length must cover one window")
    if n >= (1 << _POS_BITS):
        raise ValueError("padded read length exceeds the position field")
    dev = seq.device
    sequ = _upper(seq)
    fwd = hash_kmers(sequ, k)
    if alphabet_size == 4:
        bwd = hash_kmers(_complement(sequ).flip(-1), k).flip(-1)
    else:
        bwd = torch.full_like(fwd, _U32_MAX)
    pos = torch.arange(n, device=dev)
    valid = (fwd != bwd) & (pos[None, :] < n_kmers_valid.to(torch.int64)[:, None])
    canon = torch.minimum(fwd, bwd)
    strand = torch.where(fwd < bwd, 1, -1).to(torch.int8)

    key = canon | ((~valid).to(torch.int64) << 32)
    pos_mask = (1 << _POS_BITS) - 1
    wmin = _window_min((key << _POS_BITS) | (pos_mask - pos)[None, :], w)
    min_key = wmin >> _POS_BITS
    m = pos_mask - (wmin & pos_mask)  # winning k-mer position per window
    nw = n - w + 1
    evaluated = valid[:, w - 1:] & (min_key < (1 << 32))

    # the deque front m is nondecreasing over evaluated windows, so the
    # previous evaluated window's m is a running max
    prev_incl = torch.cummax(torch.where(evaluated, m, -1), dim=1).values
    prev_m = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int64, device=dev),
         prev_incl[:, :-1]], dim=1)
    emit = evaluated & (m != prev_m)
    h = min_key & _U32_MAX
    st = torch.gather(strand, 1, m)

    # wpos-0 chain: when window 0 emits, following records equal to it in
    # (hash, strand) are dropped up to the first record that differs
    j = torch.arange(nw, device=dev)
    differs = emit & ((h != h[:, :1]) | (st != st[:, :1])) & (j[None, :] > 0)
    first_diff = torch.where(differs, j[None, :], nw).amin(dim=1, keepdim=True)
    chained = emit[:, :1] & (j[None, :] > 0) & (j[None, :] < first_diff)
    emit = emit & ~chained
    return emit, h, st, evaluated
