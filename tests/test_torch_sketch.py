"""Port sketch stage vs the JAX package: MurmurHash3 goldens, the jax-free
winnowing copies, the torch ``winnow_dense``, and ``sketch`` against
``batch_sketch``. Every output is integer and must be exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamaps_tpu.ops import murmur3 as jmur
from metamaps_tpu.ops import winnow as jwin
from metamaps_tpu.ops.batch_map import MapKernelConfig, batch_sketch
from metamaps_tpu_torch.ops import murmur3 as tmur
from metamaps_tpu_torch.ops import winnow as twin
from metamaps_tpu_torch.ops.sketch import sketch

from util_sim import random_genome, sample_reads

GOLDEN = [  # tests/test_murmur3.py: reference murmur3, seed 42, low 32 of h1
    ("ACGTACGTACGTACGT", 0xAC055887),
    ("AAAAAAAAAAAAAAAA", 0xB20A1D07),
    ("GATTACA", 0x0F219870),
    ("ACGTNNACGTACGTACGTACGTA", 0x01FAF439),
    ("TTTTGGGGCCCCAAAATTTTGGGGCCCCAAAA", 0xE7456798),
    ("A", 0x39C26128),
    ("ACGTACGTACGTACG", 0x10C981C6),
]


@pytest.mark.parametrize("s,expected", GOLDEN)
def test_murmur3_goldens(s, expected):
    b = np.frombuffer(s.encode(), dtype=np.uint8)
    assert int(tmur.hash_kmers_np(b, len(s))[0]) == expected
    assert int(tmur.hash_kmers(torch.from_numpy(b.copy()), len(s))[0]) == expected


@pytest.mark.parametrize("k", [3, 5, 8, 9, 15, 16, 17, 24, 31, 32, 33])
def test_murmur3_batched_matches_jax_package(k):
    rng = np.random.default_rng(k)
    seqs = rng.integers(0, 256, size=(3, 300), dtype=np.uint8)
    got = tmur.hash_kmers(torch.from_numpy(seqs), k).numpy()
    for r in range(3):
        want = jmur.hash_kmers_np(seqs[r], k)
        np.testing.assert_array_equal(tmur.hash_kmers_np(seqs[r], k), want)
        np.testing.assert_array_equal(got[r], want.astype(np.int64))


def _odd_sequences(rng):
    """Lower case, N, symmetric k-mers (ACGT repeats), homopolymers (the
    wpos-0 chain), and plain random bases."""
    alpha = np.frombuffer(b"ACGTacgtN", np.uint8)
    out = []
    for i in range(10):
        n = int(rng.integers(70, 900))
        s = rng.choice(alpha, size=n,
                       p=[.22, .22, .22, .22, .02, .02, .02, .02, .04])
        if i % 3 == 0:
            s[:64] = np.frombuffer(b"ACGT" * 16, np.uint8)
        if i % 4 == 1:
            s[:] = ord("A")
        out.append(s)
    return out


@pytest.mark.parametrize("k,w,a", [(16, 16, 4), (16, 8, 4), (15, 13, 4),
                                   (5, 16, 20)])
def test_winnow_copies_and_dense_match_jax_package(k, w, a):
    rng = np.random.default_rng(k * 100 + w)
    seqs = _odd_sequences(rng)
    L = 1000
    batch = np.full((len(seqs), L), ord("A"), np.uint8)
    nv = np.zeros(len(seqs), np.int64)
    for i, s in enumerate(seqs):
        batch[i, : len(s)] = s
        nv[i] = len(s) - k + 1
    emit, h, st, _ = twin.winnow_dense(torch.from_numpy(batch),
                                       torch.from_numpy(nv), k, w, a)
    for i, s in enumerate(seqs):
        want = jwin.winnow_np(s, k, w, a)
        for got in (twin.winnow_np(s, k, w, a), twin.winnow_oracle(s, k, w, a)):
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
        idx = np.flatnonzero(emit[i].numpy())
        np.testing.assert_array_equal(idx, want[1])
        np.testing.assert_array_equal(h[i].numpy()[idx], want[0].astype(np.int64))
        np.testing.assert_array_equal(st[i].numpy()[idx], want[2])


def test_winnow_fast_matches_jax_package():
    rng = np.random.default_rng(3)
    g = random_genome(rng, 20000)
    for x, y in zip(twin.winnow_fast(g, 16, 12), jwin.winnow_fast(g, 16, 12)):
        np.testing.assert_array_equal(x, y)


def test_sketch_matches_batch_sketch():
    rng = np.random.default_rng(11)
    genomes = [random_genome(rng, 30000) for _ in range(2)]
    seqs = [r[0] for r in sample_reads(rng, genomes, 6, min_len=1200,
                                       max_len=4000, sub=0.06)]
    seqs.append(np.tile(genomes[0][100:400], 10))  # repeats: duplicate hashes
    seqs.append(random_genome(rng, 20))  # shorter than one window
    cfg = MapKernelConfig.for_read_len(4096, 16, 16, l2_impl="scatter")
    reads = np.full((len(seqs), 4096), ord("A"), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = s
        lens[i] = len(s)
    want = batch_sketch(cfg, jnp.asarray(reads), jnp.asarray(lens))
    got = sketch(torch.from_numpy(reads), torch.from_numpy(lens), 16, 16,
                 cfg.sketch_max)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_).astype(g.numpy().dtype))
