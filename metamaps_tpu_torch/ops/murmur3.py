"""Bit-exact MurmurHash3_x64_128 k-mer hashing (numpy host copy + torch).

Counterpart: ``metamaps_tpu/ops/murmur3.py``. The reference hashes every
k-mer with MurmurHash3_x64_128, seed 42, and keeps the low 32 bits of h1
(src/common/murmur3.h:226-303, commonFunc.hpp:71-81).

- :func:`hash_kmers_np` is a jax-free copy of the JAX package's numpy
  implementation (the index build and the serial oracle use it);
- :func:`hash_kmers` is the batched torch version. PyTorch has no unsigned
  64-bit arithmetic, so the 64-bit lanes are ``int64`` tensors: additions
  and multiplications wrap modulo 2^64 exactly as unsigned ones do, constants
  above 2^63 become their negative two's-complement literals, and right
  shifts (arithmetic on ``int64``) are masked into logical shifts. The
  result is the uint32 hash held in an ``int64`` tensor, so sort order is
  uint32 order.
"""
from __future__ import annotations

import numpy as np
import torch

SEED = 42  # reference: commonFunc.hpp:33

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53


# ---------------------------------------------------------------------------
# numpy implementation (uint64 native) — copy of metamaps_tpu.ops.murmur3
# ---------------------------------------------------------------------------


def _np_rotl(x, r):
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _np_fmix(k):
    k ^= k >> np.uint64(33)
    k *= np.uint64(_F1)
    k ^= k >> np.uint64(33)
    k *= np.uint64(_F2)
    k ^= k >> np.uint64(33)
    return k


def _np_words64(seq: np.ndarray, k: int, n: int, byte_off: int) -> np.ndarray:
    """LE uint64 words from bytes [i+byte_off, i+byte_off+8) for each kmer
    start i in [0, n); bytes at or beyond offset k within the kmer are 0."""
    out = np.zeros(n, dtype=np.uint64)
    for b in range(8):
        off = byte_off + b
        if off >= k:
            break
        out |= seq[off:off + n].astype(np.uint64) << np.uint64(8 * b)
    return out


def hash_kmers_np(seq: np.ndarray, k: int, seed: int = SEED) -> np.ndarray:
    """Hash all k-mers of ``seq`` (uint8, ASCII upper-case bases).

    Returns uint32 array of length len(seq)-k+1 (empty if seq shorter
    than k).
    """
    assert seq.dtype == np.uint8
    n = int(seq.shape[0]) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h1 = np.full(n, seed, dtype=np.uint64)
        h2 = np.full(n, seed, dtype=np.uint64)
        c1 = np.uint64(_C1)
        c2 = np.uint64(_C2)

        nblocks = k // 16
        for i in range(nblocks):
            k1 = _np_words64(seq, k, n, 16 * i)
            k2 = _np_words64(seq, k, n, 16 * i + 8)
            k1 *= c1
            k1 = _np_rotl(k1, 31)
            k1 *= c2
            h1 ^= k1
            h1 = _np_rotl(h1, 27)
            h1 += h2
            h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
            k2 *= c2
            k2 = _np_rotl(k2, 33)
            k2 *= c1
            h2 ^= k2
            h2 = _np_rotl(h2, 31)
            h2 += h1
            h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

        tail = k & 15
        if tail > 8:
            k2 = _np_words64(seq, k, n, nblocks * 16 + 8)
            k2 *= c2
            k2 = _np_rotl(k2, 33)
            k2 *= c1
            h2 ^= k2
        if tail > 0:
            k1 = _np_words64(seq, k, n, nblocks * 16)
            k1 *= c1
            k1 = _np_rotl(k1, 31)
            k1 *= c2
            h1 ^= k1

        h1 ^= np.uint64(k)
        h2 ^= np.uint64(k)
        h1 += h2
        h2 += h1
        h1 = _np_fmix(h1)
        h2 = _np_fmix(h2)
        h1 += h2
        # (h2 += h1 does not affect the returned low bits of h1)
    return (h1 & np.uint64(0xFFFFFFFF)).astype(np.uint32)


# ---------------------------------------------------------------------------
# torch implementation (int64 lanes, wrapping arithmetic)
# ---------------------------------------------------------------------------


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor (the arithmetic shift with
    the sign-extended top bits masked off)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _shr(k, 33)
    k = k * _s64(_F1)
    k = k ^ _shr(k, 33)
    k = k * _s64(_F2)
    return k ^ _shr(k, 33)


def _words64(seq64: torch.Tensor, k: int, n: int, byte_off: int) -> torch.Tensor:
    out = torch.zeros(seq64.shape[:-1] + (n,), dtype=torch.int64,
                      device=seq64.device)
    for b in range(8):
        off = byte_off + b
        if off >= k:
            break
        out |= seq64[..., off:off + n] << (8 * b)
    return out


def hash_kmers(seq: torch.Tensor, k: int, seed: int = SEED) -> torch.Tensor:
    """Torch version of :func:`hash_kmers_np`, batched over leading dims.

    ``seq``: uint8 ``[..., L]``. Returns ``int64 [..., L-k+1]`` holding the
    uint32 hashes (position i = hash of bytes [i, i+k))."""
    n = int(seq.shape[-1]) - k + 1
    if n <= 0:
        raise ValueError("sequence shorter than k")
    seq64 = seq.to(torch.int64)
    c1, c2 = _s64(_C1), _s64(_C2)
    h1 = torch.full(seq.shape[:-1] + (n,), seed, dtype=torch.int64,
                    device=seq.device)
    h2 = h1.clone()

    nblocks = k // 16
    for i in range(nblocks):
        k1 = _words64(seq64, k, n, 16 * i)
        k2 = _words64(seq64, k, n, 16 * i + 8)
        k1 = _rotl(k1 * c1, 31) * c2
        h1 = _rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = _rotl(k2 * c2, 33) * c1
        h2 = _rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5

    tail = k & 15
    if tail > 8:
        k2 = _words64(seq64, k, n, nblocks * 16 + 8)
        h2 = h2 ^ (_rotl(k2 * c2, 33) * c1)
    if tail > 0:
        k1 = _words64(seq64, k, n, nblocks * 16)
        h1 = h1 ^ (_rotl(k1 * c1, 31) * c2)

    h1 = h1 ^ k
    h2 = h2 ^ k
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1) + _fmix(h2)
    return h1 & 0xFFFFFFFF
