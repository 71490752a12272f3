"""The wide sweep kernel's split of each candidate's event stream into
chunks (``csrc/l2_sweep_wide.cu``), on the CPU.

Two models of that decomposition must equal the plain sweep
``l2_event_sweep_ref`` bit for bit at every chunk length L (1, 2, 63, 64,
65, the longest candidate's n_ev, and more than E2):

- ``l2_event_sweep_split_ref`` (``ops/l2_sweep.py``), the decomposition in
  plain PyTorch: delta planes per chunk, start planes by cumulative sums
  over the chunks before, one plain sweep per chunk from its state, folds
  combined in order;
- the kernel's own algorithm in plain Python (``model_sweep`` of
  ``tests/test_torch_sweep_incremental.py`` with ``chunk``): at each
  chunk's first event the chain's state (the count of negative ranks, J,
  C[J - 1], the count, C in place of r in recount mode) is derived afresh
  from the planes, and the fold is the kernel's per-chunk fold, combined
  by a warp over the chunks.

The streams: random signs (recount mode across chunk boundaries), paired
(setup-shaped: incremental mode only) and mixed (4 % of the ref-only
occurrences flipped), a stream with heavy row ties (boundaries between
equal rows), and the contract's edge cases (empty candidates, n_ev < 0 or
> E2, row_lo > row_hi, ranks outside [0, sp)). The split model is also held
once against the JAX kernel ``l2_event_sweep_batch(..., interpret=True)``,
and :func:`wide_plan`, which picks L and the workspace, against its
contract.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamaps_tpu.ops.l2_pallas import l2_event_sweep_batch
from metamaps_tpu_torch.ops.l2_sweep import (
    I32_MAX,
    TILE_EVENTS,
    WIDE_MIN_CHUNK_EVENTS,
    WIDE_WORKSPACE_CAP,
    l2_event_sweep_ref,
    l2_event_sweep_split_ref,
    l2_event_sweep_wide,
    paired_event_streams,
    random_event_streams,
    wide_plan,
)

from test_torch_sweep_incremental import _edge_cases, model_sweep
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

SP = 256
KINDS = ("random", "paired", "mixed", "ties", "edge")
CHUNKS = (1, 2, 63, 64, 65, "n_ev", "over")


def _streams(kind):
    """(meta, qrank, signinq, rows) numpy int32 streams of one kind."""
    rng = np.random.default_rng(KINDS.index(kind) + 70)
    if kind == "random":
        return random_event_streams(rng, 16, 240, SP - 1)
    if kind == "paired":
        return paired_event_streams(rng, 16, 240, SP - 1)
    if kind == "mixed":
        return paired_event_streams(rng, 16, 240, SP - 1, flip=0.04)
    if kind == "ties":  # ~70 distinct rows over up to 240 events
        return paired_event_streams(rng, 16, 240, SP - 1, flip=0.04,
                                    row_span=8)
    return _edge_cases(SP)


@pytest.fixture(scope="module")
def cases():
    """Each kind's streams and the plain sweep's output on them."""
    out = {}
    for kind in KINDS:
        arrs = _streams(kind)
        out[kind] = (arrs, l2_event_sweep_ref(
            *[torch.from_numpy(a) for a in arrs], SP))
    return out


def _chunk(arrs, which):
    """The chunk length that ``which`` names on these streams."""
    n_ev = np.clip(arrs[0][:, 3], 0, arrs[1].shape[1])
    if which == "n_ev":
        return int(n_ev.max())
    if which == "over":
        return arrs[1].shape[1] + 5
    return which


@pytest.mark.parametrize("which", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_split_ref_equals_plain(cases, kind, which):
    arrs, want = cases[kind]
    got = l2_event_sweep_split_ref(*[torch.from_numpy(a) for a in arrs], SP,
                                   _chunk(arrs, which))
    assert torch.equal(got, want)
    assert (want[:, 0] > 0).sum() >= 3


@pytest.mark.parametrize("which", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_equals_plain(cases, kind, which):
    """The chunk kernel's state derivation and fold, in plain Python."""
    arrs, want = cases[kind]
    got, *_ = model_sweep(*arrs, SP, chunk=_chunk(arrs, which))
    np.testing.assert_array_equal(got, want.numpy())


def _negative_after(arrs, e):
    """For each candidate with more than ``e`` events: is some rank's
    ref-only multiplicity negative just after event ``e`` (recount mode)?"""
    meta, qrank, signinq, _ = arrs
    out = []
    for c in range(meta.shape[0]):
        if min(max(int(meta[c, 3]), 0), qrank.shape[1]) <= e:
            continue
        r = np.zeros(SP, np.int64)
        for q, si in zip(qrank[c, :e + 1], signinq[c, :e + 1]):
            if si in (1, -1) and q < SP:
                r[max(q, 0)] += si
        out.append(bool((r < 0).any()))
    return out


def test_streams_cross_chunk_boundaries_in_both_modes():
    """Chunks of 63, 64 and 65 events start in recount mode on some
    random-sign and mixed candidates and never on paired ones; the tie
    stream has equal rows across those boundaries."""
    for kind in ("random", "mixed", "paired"):
        arrs = _streams(kind)
        for e in (62, 63, 64):  # the event before a chunk's first
            assert any(_negative_after(arrs, e)) == (kind != "paired")
    meta, _, _, rows = _streams("ties")
    long = meta[:, 3] > 130
    for e in (62, 63, 64):
        assert (rows[long, e] == rows[long, e + 1]).any()


def test_split_ref_equals_pallas_interpret():
    """The random, paired, mixed and tie streams in one JAX call (one
    interpret-mode compile), against the split model at L = 64 and 65."""
    parts = [_streams(kind) for kind in ("random", "paired", "mixed", "ties")]
    e2 = max(p[1].shape[1] for p in parts)
    arrs = [np.concatenate([p[0] for p in parts])]
    for k, fill in ((1, 0), (2, 0), (3, I32_MAX)):
        arrs.append(np.concatenate([
            np.pad(p[k], ((0, 0), (0, e2 - p[k].shape[1])),
                   constant_values=fill) for p in parts]))
    jax_out = np.asarray(l2_event_sweep_batch(*map(jnp.asarray, arrs), sp=SP,
                                              interpret=True))
    assert (jax_out[:, 0] > 0).sum() > 20
    for chunk in (64, 65):
        got = l2_event_sweep_split_ref(*[torch.from_numpy(a) for a in arrs],
                                       SP, chunk)
        np.testing.assert_array_equal(got.numpy(), jax_out)


@pytest.mark.parametrize("n,e2,sp", [(1, 185344, 30848), (37, 300, 28928),
                                     (2048, 6656, 30848), (3, 20000, 41088),
                                     (1, 4096, 41088)])
def test_wide_plan_default(n, e2, sp):
    """The default L: a multiple of the 64-event tile, at least the
    minimum unless E2 is shorter, at most one chunk per SM of 132 (the
    long read's slab, one candidate of 185,344 events, in 132 chunks),
    one chunk for short streams; every event in a chunk; the workspace
    under its cap."""
    L, P, W, G = wide_plan(n, e2, sp, 132)
    assert 1 <= L <= e2 and P == -(-e2 // L) and (P - 1) * L < e2
    assert L == e2 or (L % TILE_EVENTS == 0 and L >= WIDE_MIN_CHUNK_EVENTS)
    assert G * W * 8 * sp <= WIDE_WORKSPACE_CAP
    if WIDE_MIN_CHUNK_EVENTS < L < e2:
        assert n * P <= 132
    if (n, e2) == (1, 185344):
        assert (L, P, W, G) == (1408, 132, 132, 1)
    if e2 <= WIDE_MIN_CHUNK_EVENTS:
        assert (L, P, W, G) == (e2, 1, 1, n)
    if n == 2048:  # all chunks of a group at once, the groups under the cap
        assert W == P and 1 < G < n


@pytest.mark.parametrize("chunk,sp", [(1, 41088), (64, 28928), (65, 28928),
                                     (2000, 41088), (10**9, 41088)])
def test_wide_plan_forced(chunk, sp):
    """A forced L at most E2; above the cap the candidates go in groups,
    and one candidate's chunks in windows."""
    n, e2 = 3, 20000
    L, P, W, G = wide_plan(n, e2, sp, 132, chunk)
    assert L == min(chunk, e2) and P == -(-e2 // L)
    assert 1 <= W <= P and 1 <= G <= n
    assert G * W * 8 * sp <= WIDE_WORKSPACE_CAP
    slot = 8 * sp
    if n * P * slot > WIDE_WORKSPACE_CAP:
        assert G < n
    if P * slot > WIDE_WORKSPACE_CAP:
        assert G == 1 and W == WIDE_WORKSPACE_CAP // slot
    with pytest.raises(ValueError):
        wide_plan(n, e2, sp, 132, 0)


def test_wide_wrapper_takes_the_plain_version_on_the_cpu():
    """CPU tensors take the plain version at any chunk_events, and launch
    nothing; a chunk length below 1 raises."""
    arrs = [torch.from_numpy(a) for a in _streams("mixed")]
    want = l2_event_sweep_ref(*arrs, SP)
    before = l2_event_sweep_wide.launches
    for chunk in (None, 1, 65):
        assert torch.equal(l2_event_sweep_wide(*arrs, SP, chunk_events=chunk),
                           want)
    assert l2_event_sweep_wide.launches == before
    with pytest.raises(ValueError):
        l2_event_sweep_wide(*arrs, SP, chunk_events=0)
