"""The sweep kernels' two-mode algorithm (``csrc/l2_sweep_common.cuh``, run
by ``l2_sweep.cu``, ``l2_sweep_rb.cu`` and ``l2_sweep_eager.cu``) on the
CPU.

The CUDA kernels cannot run here, so :func:`model_sweep` repeats their
logic in plain Python, one candidate at a time: incremental mode (the
prefix end J, C[J-1] and the count in registers, O(1) work per event)
while no query rank's ref-only multiplicity r is negative, recount mode (C
in place of r, a full recount after each ref-only event) while one is, the
passes that switch between them, and the fold of each tile of 64 events by
32 lanes whose partial optima combine in order. With ``warps`` > 1 the
recount is the eager kernel's, split over a block of 32 * warps threads
(thread t owns ranks j = t mod 32 * warps; the owner of the event's rank
reports the change to the count of negative ranks), and with ``eager``
the fold is the eager kernel's: each event closes its own segment with
the next event's row, the last of a tile with the next tile's first row.
It is a test helper; the package does not use it. The model must equal
the plain version ``l2_event_sweep_ref`` and the JAX kernel
``l2_event_sweep_batch(..., interpret=True)`` exactly (int32) on the real
setup streams of ``tests/test_torch_l2_sweep.py``'s slab, on paired,
random-sign and mixed streams, and on each edge case of the kernel's
contract, in every form and at the widths the kernels take (rb's sp 3584,
eager's s_pad 1024 and 2048). ``sweep_routes`` (the mode split the bound
reads) must agree with the model's own count of events per mode, the real
streams must never leave incremental mode, and no plane value may exceed
the candidate's events (the int16 planes of rb and eager).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamaps_tpu.ops.l2_pallas import l2_event_sweep_batch
from metamaps_tpu_torch.ops.l2 import round_up
from metamaps_tpu_torch.ops.l2_setup import l2_setup
from metamaps_tpu_torch.ops.l2_sweep import (
    I32_MAX,
    I32_MIN,
    l2_event_sweep_ref,
    paired_event_streams,
    random_event_streams,
)
from metamaps_tpu_torch.profiling import sweep_bench

from test_torch_l2_sweep import CFG, slab  # noqa: F401  (module fixture)
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)


TILE = 64  # the kernel's events per staged tile, two per lane in the fold
# model_sweep's arguments for each kernel: rb runs the batch kernel's warp
# chain (on int16 planes); eager recounts over a block of 128 threads at
# s_pad 1024 and 2048 (eager_threads in csrc/l2_sweep_eager.cu)
FORMS = {"rb": {}, "eager": dict(warps=4, eager=True)}


def _close(acc, prev_row, row, row_lo, row_hi, count):
    """Fold the segment [max(prev_row, row_lo), min(row - 1, row_hi)],
    scored ``count``, onto ``acc`` = (best, first, last)."""
    seg_a, seg_b = max(prev_row, row_lo), min(row - 1, row_hi)
    if seg_a <= seg_b:
        if count > acc[0]:
            return (count, seg_a, seg_b)
        if count == acc[0] and count > 0:
            return (acc[0], acc[1], seg_b)
    return acc


def _combine(a, b):
    """The fold of a later run of segments ``b`` onto an earlier run ``a``,
    each folded from (0, -1, -1)."""
    if b[0] > a[0]:
        return b
    if b[0] == a[0] and b[0] > 0:
        return (a[0], a[1], b[2])
    return a


def _combine_lanes(lanes):
    """The 32 lanes' folds combined in lane order by the kernels'
    shuffle-down tree: lane 0's result."""
    off = 1
    while off < 32:  # a lane past 31 hands back the caller's own fold
        lanes = [_combine(lanes[i], lanes[i + off] if i + off < 32
                          else lanes[i]) for i in range(32)]
        off *= 2
    return lanes[0]


def fold_tiles(rows, counts, row_lo, row_hi, prev=I32_MIN, before=0,
               trailing=True):
    """The kernel's fold of one candidate from each event's row and the
    count after it: per tile, lane l folds events 2l and 2l + 1 from (0, -1,
    -1) (the highest row before each from a max-scan), the lanes' folds
    combine by a shuffle-down tree, and the tile's fold combines onto the
    running one; then the trailing close at row_hi. ``prev`` and
    ``before`` are the highest row and the count before the first event;
    without ``trailing`` the fold stops after the last event's segment."""
    acc = (0, -1, -1)
    for t0 in range(0, len(rows), TILE):
        r, c = rows[t0:t0 + TILE], counts[t0:t0 + TILE]
        high = np.maximum.accumulate([prev] + r)  # high[i]: before event i
        lanes = []
        for lane in range(32):
            part = (0, -1, -1)
            for i in (2 * lane, 2 * lane + 1):
                if i < len(r):
                    part = _close(part, int(high[i]), r[i], row_lo, row_hi,
                                  c[i - 1] if i else before)
            lanes.append(part)
        acc = _combine(acc, _combine_lanes(lanes))
        prev, before = int(high[-1]), c[-1]
    if not trailing:
        return acc
    return _close(acc, prev, row_hi + 1, row_lo, row_hi, before)


def fold_chunks(rows, counts, row_lo, row_hi, chunk):
    """The wide kernel's fold (csrc/l2_sweep_wide.cu): each chunk of
    ``chunk`` events folds its own tiles from (0, -1, -1), from the highest
    row and the count before it; a warp combines the chunks' folds, lane l
    a contiguous run of ceil(chunks / 32) of them in order, then the lanes
    by the shuffle-down tree; the last chunk's carries close the trailing
    segment."""
    folds, prev, before = [], I32_MIN, 0
    for e0 in range(0, max(len(rows), 1), chunk):
        r, c = rows[e0:e0 + chunk], counts[e0:e0 + chunk]
        folds.append(fold_tiles(r, c, row_lo, row_hi, prev, before,
                                trailing=False))
        prev, before = max([prev] + r), (c[-1] if c else before)
    per = -(-len(folds) // 32)
    lanes = []
    for lane in range(32):
        part = (0, -1, -1)
        for f in folds[lane * per:(lane + 1) * per]:
            part = _combine(part, f)
        lanes.append(part)
    acc = _combine((0, -1, -1), _combine_lanes(lanes))
    return _close(acc, prev, row_hi + 1, row_lo, row_hi, before)


def chunk_state(r, m, s):
    """The wide kernel's state at a chunk's start from its start planes (r
    and M as multiplicities), as its block derives it: the count of
    negative ranks, then the count, J (the passing ranks) and C[J - 1]
    from the prefix C; the plane the chain starts on is C where a rank is
    negative (recount mode), else r."""
    neg = int((r < 0).sum())
    cplane = np.cumsum(r)
    passing = np.arange(len(r)) + cplane < s
    J = int(passing.sum())
    cj1 = int(cplane[J - 1]) if J else 0
    shared = int(((m > 0) & passing).sum())
    return (cplane if neg else r.copy()), shared, neg, J, cj1


def fold_tiles_eager(rows, counts, row_lo, row_hi):
    """The eager kernel's fold: event i scores [max(row_i, row_lo),
    min(row_next - 1, row_hi)] with the count after it, row_next the next
    event's row, the next tile's first row for a tile's last event, and
    row_hi + 1 after the last event (exact here: Python ints). Per tile,
    lane l folds events 2l and 2l + 1, and the lanes combine as in
    :func:`fold_tiles`; there is no trailing close."""
    acc = (0, -1, -1)
    for t0 in range(0, len(rows), TILE):
        r, c = rows[t0:t0 + TILE], counts[t0:t0 + TILE]
        after = r[1:] + [rows[t0 + TILE] if t0 + TILE < len(rows)
                         else row_hi + 1]
        lanes = []
        for lane in range(32):
            part = (0, -1, -1)
            for i in (2 * lane, 2 * lane + 1):
                if i < len(r):
                    part = _close(part, r[i], after[i], row_lo, row_hi, c[i])
            lanes.append(part)
        acc = _combine(acc, _combine_lanes(lanes))
    return acc


def model_sweep(meta, qrank, signinq, rows, sp, warps=1, eager=False,
                chunk=None):
    """The kernels' sweep on numpy inputs: the warp's recount (``warps`` 1:
    l2_sweep.cu, l2_sweep_rb.cu) or a block's of 32 * ``warps`` threads,
    the lazy fold or the eager one (l2_sweep_eager.cu). With ``chunk`` the
    events are the wide kernel's chunks of that many events: at each
    chunk's first event the chain drops its state and starts again from
    what :func:`chunk_state` derives from the planes (r, as the scan leaves
    them), and the fold is :func:`fold_chunks`. Returns ([N, 4]
    int32 output, per-candidate recount-event counts, mode entries, mode
    exits, the largest |value| a plane held over the candidate's swept
    events, at most)."""
    n, e2 = qrank.shape
    lin = np.arange(sp)
    owner = lin % (32 * warps)  # the thread that owns each rank
    out = np.zeros((n, 4), np.int32)
    recount_events = np.zeros(n, np.int64)
    entries = exits = 0
    peak = 0.0
    for c in range(n):
        s, row_lo, row_hi, n_ev = (int(v) for v in meta[c])
        n_ev = min(max(n_ev, 0), e2)
        plane = np.zeros(sp, np.int64)  # r, or C in recount mode
        m = np.zeros(sp, np.int64)
        shared, neg, counts = 0, 0, []
        J, cj1 = min(max(s, 0), sp), 0  # prefix end, C[J - 1]
        high = 0  # the largest |value| either plane has held

        def held(values):
            nonlocal high
            high = max(high, int(np.abs(values).max()))

        def count(cplane):
            """Each thread counts its own ranks, each warp sums its
            threads', the block its warps'."""
            ok = ((m > 0) & (lin + cplane < s)).astype(np.int64)
            per_thread = np.bincount(owner, weights=ok, minlength=32 * warps)
            return int(per_thread.reshape(warps, 32).sum(axis=1).sum())

        for e in range(n_ev):
            if chunk and e and e % chunk == 0:  # a chunk's block starts
                r = plane if neg == 0 else np.diff(plane, prepend=0)
                plane, shared, neg, J, cj1 = chunk_state(r, m, s)
            qr, si = int(qrank[c, e]), int(signinq[c, e])
            sign = (si > 0) - (si < 0)
            inq = si in (2, -2)
            if neg == 0:  # incremental: one lane, O(1)
                if inq and 0 <= qr < sp:
                    old = m[qr]
                    m[qr] += sign
                    held(m[qr])
                    if qr < J:
                        shared += int(m[qr] > 0) - int(old > 0)
                elif not inq and sign != 0 and qr < sp:
                    q = max(qr, 0)
                    plane[q] += sign
                    held(plane[q])
                    if sign > 0:
                        if q < J and J + cj1 >= s:
                            J -= 1
                            shared -= int(m[J] > 0)
                            cj1 += 1 - plane[J]
                        elif q < J:
                            cj1 += 1
                    elif plane[q] < 0:  # to recount mode: r -> C, recount
                        neg, entries = 1, entries + 1
                        plane = np.cumsum(plane)
                        held(plane)
                        shared = count(plane)
                    else:
                        if q < J:
                            cj1 -= 1
                        if q <= J < sp and J + cj1 + plane[J] < s:
                            shared += int(m[J] > 0)
                            cj1 += plane[J]
                            J += 1
            else:  # recount mode: the warp
                if inq and 0 <= qr < sp:
                    old = m[qr]
                    m[qr] += sign
                    held(m[qr])
                    if qr + plane[qr] < s:
                        shared += int(m[qr] > 0) - int(old > 0)
                elif not inq and sign != 0 and qr < sp:
                    q = max(qr, 0)
                    # the owner of q, before its add (C[q - 1] stays)
                    r_old = plane[q] - (plane[q - 1] if q > 0 else 0)
                    neg += int(r_old + sign < 0) - int(r_old < 0)
                    plane[q:] += sign
                    held(plane)
                    shared = count(plane)
                    if neg == 0:  # back: C -> r; J, C[J - 1] afresh
                        exits += 1
                        passing = lin + plane < s
                        J = int(passing.sum())
                        cj1 = int(plane[J - 1]) if J else 0
                        plane = np.diff(plane, prepend=0)
                        held(plane)
            recount_events[c] += int(neg > 0)
            counts.append(shared)
        row_list = [int(v) for v in rows[c, :n_ev]]
        if chunk:
            out[c] = (*fold_chunks(row_list, counts, row_lo, row_hi, chunk),
                      0)
        else:
            fold = fold_tiles_eager if eager else fold_tiles
            out[c] = (*fold(row_list, counts, row_lo, row_hi), 0)
        if n_ev:
            peak = max(peak, high / n_ev)
    return out, recount_events, entries, exits, peak


def _edge_cases(sp):
    """One candidate per edge case of the kernel's contract, each valid for
    the JAX kernel too (which sweeps all E2 events and ignores n_ev)."""
    e2 = 12
    cases = []

    def cand(s, lo, hi, events, n_ev=None):
        qr = np.zeros(e2, np.int32)
        si = np.zeros(e2, np.int32)
        rw = np.full(e2, I32_MAX, np.int32)
        for i, (row, q, sg) in enumerate(events):
            rw[i], qr[i], si[i] = row, q, sg
        cases.append(((s, lo, hi, len(events) if n_ev is None else n_ev),
                      qr, si, rw))

    base = [(0, 5, 2), (3, 9, 2), (4, 2, 1), (8, 5, -2), (9, 1, -1)]
    cand(40, 0, 20, [(0, -3, 2), (1, -1, 1), (2, 4, 2), (5, -7, -1)])  # qr < 0
    cand(40, 0, 20, [(0, 3, 2), (1, sp, 1), (2, sp + 9, 2), (4, sp, -1),
                     (6, sp - 1, 2), (7, 2, 1)])  # qr >= sp
    cand(0, 0, 20, base)  # s = 0: J = 0
    cand(-7, 0, 20, base)  # s < 0
    cand(sp + 50, 0, 20, base + [(10, 0, 1)] * 6)  # s > sp: J = sp
    cand(40, 0, 20, [(0, 5, 0), (1, 5, 2), (2, 5, 0), (3, 1, 0), (5, 5, -2)])
    cand(40, 0, 20, [], n_ev=-4)  # n_ev < 0 over padding only
    cand(40, 0, 20, [(i, i % 5, 2 - 4 * (i % 3 == 2)) for i in range(e2)],
         n_ev=e2 + 9)  # n_ev > E2, every event real
    ev = base + [(I32_MAX, 5, 1)]  # a ref-only event at INT32_MAX past n_ev
    cand(40, 0, 20, ev, n_ev=len(base))
    cand(40, -5, I32_MAX, base)  # row_hi = INT32_MAX: 64-bit segment ends
    cand(40, 3, 2, base)  # row_lo > row_hi: nothing scores
    # ties: equal rows close nothing between them; "==" with best > 0
    # extends last, ">" moves first
    cand(40, 0, 30, [(2, 1, 2), (2, 2, 2), (6, 1, -2), (6, 3, 2), (9, 2, -2),
                     (9, 2, 2), (12, 7, 2), (15, 7, -2), (15, 3, -2)])
    # a rank goes negative and recovers twice; J at 0 and sp inside recount
    cand(3, 0, 30, [(0, 0, 2), (0, 1, 2), (1, 0, -1), (2, 2, 2), (3, 0, 1),
                    (4, 1, -1), (4, 1, -1), (5, 0, 2), (6, 1, 1), (6, 1, 1),
                    (7, 2, -2), (8, 0, 1)])
    meta = np.array([c[0] for c in cases], np.int32)
    return (meta, *(np.stack([c[k] for c in cases]) for k in (1, 2, 3)))


def _tile_edges(sp):
    """Candidates whose events end at a tile of 64 or one past it, or run
    over three tiles, with equal rows across the first tile boundary: the
    eager close of a tile's last event reads the next tile's first row, or
    row_hi + 1 after the last event (INT32_MAX on the last candidate)."""
    rng = np.random.default_rng(64)
    e2 = 3 * TILE
    lengths = (TILE, 2 * TILE, TILE + 1, e2)
    meta = np.zeros((len(lengths), 4), np.int32)
    qrank = np.zeros((len(lengths), e2), np.int32)
    signinq = np.zeros((len(lengths), e2), np.int32)
    rows = np.full((len(lengths), e2), I32_MAX, np.int32)
    for i, ne in enumerate(lengths):
        rows[i, :ne] = np.sort(rng.integers(0, 300, ne))
        if ne > TILE:
            rows[i, TILE] = rows[i, TILE - 1]
        signinq[i, :ne] = rng.choice([-2, -1, 1, 2], ne)
        qrank[i, :ne] = rng.integers(0, min(sp, 200), ne)
        meta[i] = (150, 10, I32_MAX if i == 3 else 280, ne)
    return meta, qrank, signinq, rows


def _streams(kind, sp):
    rng = np.random.default_rng(sp)
    if kind == "paired":
        return paired_event_streams(rng, 40, 260, sp - 1)
    if kind == "mixed":
        return paired_event_streams(rng, 40, 260, sp - 1, flip=0.04)
    if kind == "random":
        return random_event_streams(rng, 40, 260, sp - 1)
    if kind == "tiles":
        return _tile_edges(sp)
    return _edge_cases(sp)


def _real(slab):
    _, tables, _, (qk, _, ss, lens, rows, cs, cst, cen) = slab
    st = l2_setup(tables, qk[rows], ss[rows], lens[rows], cs, cst, cen,
                  16, 16, CFG.range_max, CFG.sketch_max)
    return ((st.meta.numpy(), st.qrank.numpy(), st.signinq.numpy(),
             st.rows.numpy()), round_up(CFG.sketch_max + 1, 128))


@pytest.fixture(scope="module")
def real(slab):
    """The real setup streams, their sp, and the plain version's output on
    them (tens of seconds on the CPU, so computed once). Every query rank
    lies below sp, so the plain version gives this output at any wider
    plane too (the ranks past sp never hold an in-query hash)."""
    arrs, sp = _real(slab)
    assert int(arrs[1].max()) < sp
    want = l2_event_sweep_ref(*[torch.from_numpy(a) for a in arrs], sp)
    return arrs, sp, want


def _check(arrs, sp, pallas=True, warps=1, eager=False, want=None):
    """The model against the plain version (``want``, if given, is its
    output) and, where asked, the JAX kernel in interpret mode; returns the
    model's mode statistics."""
    got, rec, entries, exits, peak = model_sweep(*arrs, sp, warps, eager)
    if want is None:
        want = l2_event_sweep_ref(*[torch.from_numpy(a) for a in arrs], sp)
    np.testing.assert_array_equal(got, want.numpy())
    assert peak <= 1.0  # |r|, |C|, |M| <= n_ev <= E2: int16 holds them
    if pallas:
        jax_out = np.asarray(l2_event_sweep_batch(
            *map(jnp.asarray, arrs), sp=sp, interpret=True))
        np.testing.assert_array_equal(got, jax_out)
    inc, rec_routes = sweep_bench.sweep_routes(*arrs[:3], sp)
    np.testing.assert_array_equal(rec, rec_routes)
    return got, rec, entries, exits


def test_model_equals_plain_and_pallas_on_real_streams(real):
    """Real setup streams: every candidate stays in incremental mode."""
    arrs, sp, want = real
    got, rec, entries, _ = _check(arrs, sp, want=want)
    assert int(arrs[0][:, 3].max()) > 0 and (got[:, 0] > 0).sum() > 20
    assert rec.sum() == 0 and entries == 0


def test_real_streams_take_incremental_mode_only(slab):
    """The prefix form that the kernel's fast mode relies on holds on the
    setup's streams: each occurrence's add (X) precedes its removal (Y),
    and the stable sort of [x_key, next_w] (ops/l2_setup.py) keeps X before
    Y on equal rows. Swapping X and Y on equal rows breaks it."""
    arrs, sp = _real(slab)
    inc, rec = sweep_bench.sweep_routes(*arrs[:3], sp)
    n_ev = np.clip(arrs[0][:, 3], 0, arrs[1].shape[1])
    assert rec.sum() == 0 and (inc == n_ev).all() and inc.sum() > 1000
    # the kernel's bound then counts no recount at all
    _, _, counts = sweep_bench.sweep_bound(*arrs[:3], 1980.0, sp=sp)
    assert counts["recount_events"] == 0
    assert counts["ops"] == (sweep_bench.OPS_PER_INCREMENTAL_EVENT
                             * counts["incremental_events"])


@pytest.mark.parametrize("kind,sp", [
    ("paired", 128), ("paired", 1280), ("mixed", 128), ("mixed", 1280),
    ("random", 256), ("edge", 128), ("edge", 256)])
def test_model_equals_plain(kind, sp):
    arrs = _streams(kind, sp)
    got, rec, entries, exits = _check(arrs, sp, pallas=False)
    n_ev = np.clip(arrs[0][:, 3], 0, arrs[1].shape[1])
    if kind == "paired":
        assert rec.sum() == 0 and entries == 0
    elif kind in ("mixed", "edge"):  # negative ranks appear and recover
        assert entries > 0 and exits > 0 and 0 < rec.sum() < n_ev.sum()
    else:  # random signs: mostly recount mode
        assert rec.sum() > n_ev.sum() // 2
    assert (got[:, 0] > 0).sum() >= 3


def test_model_equals_pallas_interpret():
    """Paired, mixed, random-sign and edge-case streams in one JAX call
    (one interpret-mode compile), events padded to one E2."""
    sp = 256
    parts = [_streams(kind, sp) for kind in ("paired", "mixed", "random",
                                             "edge")]
    e2 = max(p[1].shape[1] for p in parts)
    arrs = [np.concatenate([p[0] for p in parts])]
    for k, fill in ((1, 0), (2, 0), (3, I32_MAX)):
        arrs.append(np.concatenate([
            np.pad(p[k], ((0, 0), (0, e2 - p[k].shape[1])),
                   constant_values=fill) for p in parts]))
    got, rec, entries, exits = _check(arrs, sp)
    assert entries > 0 and exits > 0 and (got[:, 0] > 0).sum() > 40


def _short_n_ev_streams(sp):
    """Random streams with row_hi = INT32_MAX on the candidates that have
    an event at INT32_MAX past n_ev, and n_ev short of the real events on
    others."""
    rng = np.random.default_rng(11)
    arrs = [a.copy() for a in random_event_streams(rng, 30, 90, sp - 1)]
    arrs[0][1::3, 2] = I32_MAX  # the candidates with the INT32_MAX event
    arrs[0][::5, 3] = arrs[0][::5, 3] // 2  # n_ev short of the real events
    return arrs


def test_model_equals_plain_on_contract_edges():
    """Edge cases outside what the JAX kernel shares (it ignores n_ev):
    row_hi = INT32_MAX together with an event at INT32_MAX past n_ev, and
    padding events past a short n_ev that would change the count."""
    _check(_short_n_ev_streams(128), 128, pallas=False)


@pytest.mark.parametrize("form", ["rb", "eager"])
def test_kernel_forms_equal_plain_on_real_streams(real, form):
    """The row-block and eager forms on the real setup streams, the eager
    one at its s_pad (the multiple of 1024 above sp): every candidate stays
    in incremental mode."""
    arrs, sp, want = real
    width = sp if form == "rb" else round_up(sp, 1024)
    got, rec, entries, _ = _check(arrs, width, pallas=False, want=want,
                                  **FORMS[form])
    assert (got[:, 0] > 0).sum() > 20
    assert rec.sum() == 0 and entries == 0


@pytest.mark.parametrize("kind", ["paired", "mixed", "random"])
@pytest.mark.parametrize("form,width", [("eager", 1024), ("eager", 2048),
                                        ("rb", 3584)])
def test_kernel_forms_equal_plain(kind, form, width):
    """Paired, mixed and random-sign streams at the eager kernel's widths
    (a block of four warps recounts) and at rb's widest bench plane."""
    arrs = _streams(kind, width)
    got, rec, entries, exits = _check(arrs, width, pallas=False,
                                      **FORMS[form])
    n_ev = np.clip(arrs[0][:, 3], 0, arrs[1].shape[1])
    if kind == "paired":
        assert rec.sum() == 0 and entries == 0
    elif kind == "mixed":
        assert entries > 0 and exits > 0 and 0 < rec.sum() < n_ev.sum()
    else:
        assert rec.sum() > n_ev.sum() // 2
    assert (got[:, 0] > 0).sum() >= 3


@pytest.mark.parametrize("kind", ["edge", "tiles", "short"])
@pytest.mark.parametrize("form,width", [("eager", 1024), ("rb", 3584)])
def test_kernel_forms_equal_plain_on_contract_edges(kind, form, width):
    """The contract's edges in the row-block and eager forms: row_hi =
    INT32_MAX, empty candidates and n_ev < 0, a non-zero-sign event past
    n_ev, ranks outside [0, sp), s outside [0, sp], ties; tile boundaries
    (the eager close across them); short n_ev."""
    arrs = _short_n_ev_streams(width) if kind == "short" else _streams(
        kind, width)
    got, *_ = _check(arrs, width, pallas=False, **FORMS[form])
    assert (got[:, 0] > 0).sum() >= 3


def test_sweep_routes_and_bound_on_hand_made_streams():
    """sweep_routes on known streams, and the bound it feeds."""
    e2, sp = 8, 128
    meta = np.array([[5, 0, 9, 4], [5, 0, 9, 6], [5, 0, 9, 5], [5, 0, 9, 3]],
                    np.int32)
    qrank = np.zeros((4, e2), np.int32)
    signinq = np.zeros((4, e2), np.int32)
    # 0: add then remove (incremental throughout)
    qrank[0, :4], signinq[0, :4] = [3, 3, 9, 9], [1, -1, 2, -2]
    # 1: remove first at rank 2 (negative), in-query, add back, then more;
    #    qr < 0 acts on rank 0, qr >= sp on nothing
    qrank[1, :6], signinq[1, :6] = [2, 7, 2, -4, 0, sp], [-1, 2, 1, -1, 1, -1]
    # 2: two ranks negative at once; n_ev 5 leaves event 5 unswept
    qrank[2, :6], signinq[2, :6] = [1, 4, 1, 9, 4, 4], [-1, -1, 1, 0, 1, 1]
    # 3: n_ev 3 of 4 real events; sign 0 and |si| == 2 change no rank
    qrank[3, :4], signinq[3, :4] = [6, 6, 6, 6], [0, -2, 2, -1]
    inc, rec = sweep_bench.sweep_routes(meta, qrank, signinq, sp)
    # candidate 1: events 0, 1 recount; 2 back; 3 (rank 0) recount; 4 back
    # candidate 2: events 0..3 recount, 4 back
    assert inc.tolist() == [4, 3, 1, 3] and rec.tolist() == [0, 3, 4, 0]
    ms, by, counts = sweep_bench.sweep_bound(meta, qrank, signinq, 1980.0,
                                             sp=sp)
    width = np.array([10, 8, 0, 7])  # up to the highest in-query rank
    ops = (sweep_bench.OPS_PER_INCREMENTAL_EVENT * inc.sum()
           + sweep_bench.OPS_PER_PLANE_ELEMENT * (rec * width).sum())
    assert counts["ops"] == ops and counts["recount_events"] == 7
    assert counts["recount_ops"] == 3 * (meta[:, 3] * width).sum()
    rate = 132 * 64 * 1980e6
    n_bytes = 4 * 16 + 3 * 18 * 4 + 4 * 16
    assert counts["bytes"] == n_bytes
    assert ms == max(n_bytes / 3.35e12, ops / rate) * 1e3
    assert counts["recount_ms"] == max(n_bytes / 3.35e12,
                                       counts["recount_ops"] / rate) * 1e3
    # without sp (the ablation) every swept event counts as a recount
    _, _, all_rec = sweep_bench.sweep_bound(meta, qrank, signinq, 1980.0)
    assert all_rec["ops"] == all_rec["recount_ops"] == counts["recount_ops"]
