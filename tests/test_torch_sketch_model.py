"""The sketch kernel's algorithm (``csrc/sketch.cu``) as a numpy model, held
to the torch chain (``ops/sketch.py`` ``sketch_ref``) on the CPU.

The model walks each read as the kernel does: tiles of positions, windows
ending in the tile, a record wherever the window minimum's hash changes,
records appended to a bounded buffer that is flushed (sort, drop duplicates
and hashes already held, merge into a set capped at S + 1) when it would
overflow, then the buffer sorted and its first record per hash written
out. Small tiles and buffers drive the flush and the cap on short reads;
the kernel itself is held to the torch chain on the card
(``tests/test_torch_sketch_kernel.py``)."""
import numpy as np
import pytest
import torch

from metamaps_tpu_torch.ops.sketch import (RB_MAX, SMEM_DYN_MAX, TILE,
                                           sketch, sketch_plan, sketch_ref,
                                           smem_bytes)
from metamaps_tpu_torch.ops.winnow import canonical_hashes_np

from util_sim import random_genome
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

U32_MAX = 0xFFFFFFFF


def _flush(buf, held, cap):
    """The kernel's ``flush``: ``buf`` records (hash, window, strand bit) in
    window order; ``held`` the set, sorted by hash, at most ``cap``."""
    have = {h for h, _, _ in held}
    new, seen = [], set()
    for r in sorted(buf):
        if r[0] not in seen and r[0] not in have:
            new.append(r)
        seen.add(r[0])
    return sorted(held + new)[:cap]


def kernel_model(reads, lens, k, w, S, alphabet_size, tile, rb):
    B, L = reads.shape
    q_hash = np.full((B, S), U32_MAX, np.int64)
    q_strand = np.zeros((B, S), np.int8)
    size = np.zeros(B, np.int64)
    for b in range(B):
        seq = reads[b, :min(int(lens[b]), L)]
        nk = max(len(seq) - k + 1, 0)
        if nk:
            canon, strand, valid = canonical_hashes_np(seq, k, alphabet_size)
        buf, held, spilled, prev = [], [], False, None
        for p0 in range(0, nk, tile):
            recs = []
            for e in range(p0, p0 + tile):
                rec = None
                if w - 1 <= e < nk and valid[e]:
                    win = range(e - w + 1, e + 1)
                    m = min(win, key=lambda p: (not valid[p], canon[p], -p))
                    rec = (int(canon[m]), e, int(strand[m] < 0))
                if rec is not None and (prev is None or rec[0] != prev[0]):
                    recs.append(rec)
                prev = rec
            if len(buf) + len(recs) > rb:
                held, buf, spilled = _flush(buf, held, S + 1), [], True
            buf += recs
        if spilled:
            out = _flush(buf, held, S + 1)
        else:
            out, seen = [], set()
            for r in sorted(buf):
                if r[0] not in seen:
                    out.append(r)
                seen.add(r[0])
        size[b] = len(out)
        for i, (h, _, sbit) in enumerate(out[:S]):
            q_hash[b, i] = h
            q_strand[b, i] = -1 if sbit else 1
    return q_hash, q_strand, np.minimum(size, S), size > S


def _batch(seqs, L):
    reads = np.full((len(seqs), L), ord("A"), np.uint8)
    lens = np.zeros(len(seqs), np.int64)
    for i, s in enumerate(seqs):
        reads[i, :len(s)] = s
        lens[i] = len(s)
    return reads, lens


def _odd_sequences(rng, n_reads=8):
    """Lower case, N, ACGT repeats (symmetric k-mers), homopolymers (the
    wpos-0 chain), a read shorter than one window, random bases."""
    alpha = np.frombuffer(b"ACGTacgtN", np.uint8)
    out = []
    for i in range(n_reads):
        n = int(rng.integers(70, 500))
        s = rng.choice(alpha, size=n,
                       p=[.22, .22, .22, .22, .02, .02, .02, .02, .04])
        if i % 3 == 0:
            s[:64] = np.frombuffer(b"ACGT" * 16, np.uint8)
        if i % 4 == 1:
            s[:] = ord("A")
        out.append(s)
    out.append(random_genome(rng, 20))
    return out


@pytest.mark.parametrize("k,w,a", [(16, 16, 4), (15, 5, 4), (17, 1, 4),
                                   (5, 16, 20), (33, 50, 4)])
@pytest.mark.parametrize("tile,rb,S", [(TILE, 2 * TILE, 384), (16, 32, 384),
                                       (16, 16, 24), (8, 64, 7)],
                         ids=["one_tile", "flushes", "flushes_cap", "cap"])
def test_kernel_model_equals_the_torch_chain(k, w, a, tile, rb, S):
    rng = np.random.default_rng(k * 1000 + w * 10 + S)
    reads, lens = _batch(_odd_sequences(rng), 560)
    want = sketch_ref(torch.from_numpy(reads), torch.from_numpy(lens), k, w,
                      S, a)
    got = kernel_model(reads, lens, k, w, S, a, tile, rb)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_.numpy())


def test_sketch_takes_the_torch_chain_on_the_cpu():
    rng = np.random.default_rng(5)
    reads, lens = _batch(_odd_sequences(rng, 4), 600)
    before = sketch.launches
    got = sketch(torch.from_numpy(reads), torch.from_numpy(lens), 16, 16, 128)
    want = sketch_ref(torch.from_numpy(reads), torch.from_numpy(lens), 16, 16,
                      128)
    assert sketch.launches == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("L,k,w,S,plan", [
    (8192, 16, 16, 1280, (2048, 4096, True, False)),  # zymo's largest bucket
    (1024, 16, 16, 256, (2048, 1024, False, False)),
    (65536, 16, 16, 9728, (2048, RB_MAX, True, False)),
    (65536, 16, 1, 82048, (1024, RB_MAX, True, False)),
    (4096, 15, 2000, 128, (4096, TILE, True, False)),
])
def test_sketch_plan(L, k, w, S, plan):
    assert sketch_plan(L, k, w, S) == plan
    assert smem_bytes(*plan[:2]) <= SMEM_DYN_MAX


def test_sketch_plan_shrinks_the_buffer_then_gives_up_for_wide_windows():
    # 2S asks for RB_MAX records, which the ring of 16,384 keys leaves no
    # room for
    assert sketch_plan(65536, 16, 9000, 8000) == (16384, 8192, True, False)
    # the widest ring shared memory holds ...
    kcap, rb, _, gring = sketch_plan(65536, 16, 15361, 8000)
    assert (kcap, gring) == (16384, False)
    assert smem_bytes(kcap, rb) <= SMEM_DYN_MAX
    # ... and one key more gives shared memory up: the ring goes to the
    # workspace, and the buffer takes the room
    assert sketch_plan(65536, 16, 15362, 8000) == (32768, RB_MAX, True, True)
    assert sketch_plan(65536, 16, 20000, 128) == (32768, TILE, True, True)
    assert smem_bytes(0, RB_MAX) <= SMEM_DYN_MAX


def test_kernel_model_windows_wider_than_a_tile():
    """Windows spanning many tiles, as a ring in the workspace holds them."""
    rng = np.random.default_rng(7)
    reads, lens = _batch(_odd_sequences(rng, 5), 560)
    want = sketch_ref(torch.from_numpy(reads), torch.from_numpy(lens), 16,
                      300, 64)
    got = kernel_model(reads, lens, 16, 300, 64, 4, 16, 32)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_.numpy())
