"""The ablation kernel's decomposition (``csrc/l2_sweep_parts.cu``) on the
CPU.

The CUDA kernel cannot run here, so :func:`model_parts` repeats its split
in numpy: each candidate's ranks go to ``splits`` CTAs of ``warps`` sweep
warps, thread t of CTA c owning ranks c * 32 W R + t + r * 32 W (r < R),
padding ranks at or above sp included; each event is decoded as the
stager decodes it; each warp's count of an event is its partial, and the
leader sums the partials of a tile of 64 events, takes the tile's max for
acc, reseeds best and acc before every even tile and folds the tile's
segments as ``l2sweep::fold_tile`` does (32 lanes of two events, combined
by a shuffle-down tree onto the carried state). It is a test helper; the
package does not use it. The model must equal the plain version
``l2_sweep_parts_ref`` exactly, in every mode, at every split, and the
plain version's planes must have their closed form.
"""
import numpy as np
import pytest
import torch

from metamaps_tpu_torch.ops.l2_sweep_parts import (
    MAX_SPLITS,
    l2_sweep_parts,
    l2_sweep_parts_ref,
)

from test_torch_sweep_incremental import _close, _combine_lanes, _combine
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

TILE = 64  # events per tile; the TPU's 128-event block is two tiles
I32_MAX = 2**31 - 1
MODES = ("cms", "cmsf", "c", "m", "f", "s")


def model_config(n, sp, splits=None, sms=132):
    """``l2_sweep_parts_config`` of the kernel: (splits, R, sweep warps)."""
    if splits is None:
        splits = min(max(sms // max(n, 1), 1), MAX_SPLITS)
    ranks = -(-sp // splits)
    for r in (1, 2, 4):
        warps = -(-ranks // (32 * r))
        if warps <= 16 or (r == 4 and warps <= 31):
            return splits, r, warps
    raise ValueError(f"sp={sp} too wide")


def _fold_tile(rows, counts, row_lo, row_hi, p_carry, s_carry, state):
    """``l2sweep::fold_tile`` on one tile: lane l closes the segments
    before events 2l and 2l + 1 (the highest row before each from a
    max-scan seeded with ``p_carry``; the count before the first is
    ``s_carry``), the lanes' folds from (0, -1, -1) combine in lane order
    and onto ``state``. Returns (state, p_carry, s_carry) after the tile."""
    high = np.maximum.accumulate([p_carry] + rows)  # high[i]: before event i
    lanes = []
    for lane in range(32):
        part = (0, -1, -1)
        for i in (2 * lane, 2 * lane + 1):
            before = counts[i - 1] if i else s_carry
            part = _close(part, int(high[i]), rows[i], row_lo, row_hi, before)
        lanes.append(part)
    return (_combine(state, _combine_lanes(lanes)), int(high[-1]),
            counts[-1])


def model_parts(meta, qrank, signinq, rows, sp, mode, splits, r=None,
                warps=None):
    """The kernel's split of the ablation on numpy inputs; returns (out,
    fold, planes) as ``l2_sweep_parts_ref`` does."""
    n, e2 = qrank.shape
    _, r_cfg, w_cfg = model_config(n, sp, splits)
    R, W = r or r_cfg, warps or w_cfg
    threads = 32 * W
    width = splits * threads * R  # every CTA's ranks, padding included
    assert width >= sp
    j = np.arange(width)
    cta, within = j // (threads * R), j % (threads * R)
    warp = (within % threads) // 32  # thread t = within % threads
    owner = np.zeros((width, splits * W), np.int64)  # rank -> its partial
    owner[j, cta * W + warp] = 1
    s = meta[:, 0:1].astype(np.int64)
    jc = np.tile(j, (n, 1)).astype(np.int64)  # j + C[j]
    mv = np.zeros((n, width), np.int64)
    n_tiles = e2 // 128 * 2
    counts = np.zeros((n, n_tiles * TILE), np.int64)
    for e in range(n_tiles * TILE):
        qr = qrank[:, e].astype(np.int64)[:, None]
        si = signinq[:, e][:, None]
        inq = (si == 2) | (si == -2)
        cq = np.where(inq, I32_MAX, qr)  # the stager's decode
        mq = np.where(inq & (qr < sp), qr, -1)
        sign = np.where(si > 0, 1, -1)
        if "c" in mode:
            jc += np.where(j >= cq, sign, 0)
        if "m" in mode:
            mv += np.where(j == mq, sign, 0)
        if "s" in mode:
            partials = ((mv > 0) & (jc < s)).astype(np.int64) @ owner
            counts[:, e] = partials.sum(axis=1)
    out = np.zeros((n, 4), np.int32)
    fold = np.zeros((n, 4), np.int32)
    for c in range(n):
        _, row_lo, row_hi, _ = (int(v) for v in meta[c])
        acc, state, p_carry, s_carry = 0, (0, 0, 0), 0, 0
        for k in range(n_tiles):
            if k % 2 == 0:  # a 128-event block starts: reseed
                acc = max(acc, state[0])
                state = (acc, state[1], state[2])
            tile = counts[c, k * TILE:(k + 1) * TILE].tolist()
            if "f" in mode:
                state, p_carry, s_carry = _fold_tile(
                    [int(v) for v in rows[c, k * TILE:(k + 1) * TILE]], tile,
                    row_lo, row_hi, p_carry, s_carry, state)
            acc = max(acc, max(tile))
        out[c] = acc
        fold[c] = (*state, p_carry)
    planes = np.stack([(jc - j)[:, :sp], mv[:, :sp]], axis=1).astype(np.int32)
    return out, fold, planes


def parts_streams(seed, n, e2, sp, row_span=600):
    """The ablation script's generator (ranks below 1024, signs in {+-1,
    +-2}, sorted rows) at a small size, plus zero signs (counted as -1),
    ranks below 0 and at or above sp, and s from below 0 to above sp."""
    rng = np.random.default_rng(seed)
    qrank = rng.integers(0, min(1024, sp - 1), (n, e2), dtype=np.int32)
    odd = rng.random((n, e2))
    qrank[odd < 0.02] = -3
    qrank[(odd > 0.02) & (odd < 0.04)] = sp + 5
    signinq = rng.choice([1, -1, 2, -2, 0], (n, e2)).astype(np.int32)
    rows = np.sort(rng.integers(0, row_span, (n, e2)), axis=1).astype(np.int32)
    s = rng.integers(sp // 4, sp, n)
    s[0], s[-1] = -5, sp + 40
    meta = np.stack([s, np.zeros(n), np.full(n, row_span - 1),
                     np.full(n, e2)], axis=1).astype(np.int32)
    meta[1, 1:3] = (row_span // 3, row_span // 2)  # a narrow row range
    return meta, qrank, signinq, rows


@pytest.mark.parametrize("e2", [45, 128, 3 * 128 + 45])
@pytest.mark.parametrize("sp", [256, 384, 1152])
def test_model_equals_plain(sp, e2):
    """Every mode at splits 1, 2 and 4 against the plain version; E2 = 45
    sweeps nothing, and the tail past the last whole 128-event block is
    never swept."""
    arrs = parts_streams(sp + e2, 7, e2, sp)
    args = [torch.from_numpy(a) for a in arrs]
    for mode in MODES:
        want = [w.numpy() for w in l2_sweep_parts_ref(*args, sp, mode)]
        for splits in (1, 2, 4):
            got = model_parts(*arrs, sp, mode, splits)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{mode} {splits}")
        if e2 < 128:
            assert not any(w.any() for w in want)
        elif {"m", "s"} <= set(mode):
            assert (want[0][:, 0] > 0).sum() >= 5
    # cms and cmsf write the same output; the fold never exceeds it
    cmsf = l2_sweep_parts_ref(*args, sp, "cmsf")
    assert torch.equal(cmsf[0], l2_sweep_parts_ref(*args, sp, "cms")[0])
    assert (cmsf[1][:, 0] <= cmsf[0][:, 0]).all()


@pytest.mark.parametrize("r,warps", [(1, 16), (4, 3), (4, 1)])
def test_model_rank_layouts_equal_plain(r, warps):
    """Other ranks per thread and warps per CTA than the kernel's own at
    sp 384, on as few CTAs as cover sp (R = 4 with one warp holds 128 ranks
    a CTA, so it takes three): the split of the ranks changes no result."""
    sp, e2 = 384, 2 * 128 + 7
    arrs = parts_streams(r, 5, e2, sp)
    args = [torch.from_numpy(a) for a in arrs]
    want = [w.numpy() for w in l2_sweep_parts_ref(*args, sp, "cmsf")]
    splits = 1 if 32 * warps * r >= sp else -(-sp // (32 * warps * r))
    for g, w in zip(model_parts(*arrs, sp, "cmsf", splits, r, warps), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["cmsf", "c", "m", "s"])
def test_plain_planes_have_their_closed_form(mode):
    """C[j] is the sum of the signs (+1 if si > 0 else -1) of the swept
    ref-only events (|si| != 2) with qr <= j; M[j] the sum of the signs of
    the swept in-query events with qr == j. A plane whose letter is not in
    the mode stays zero; the wrapper on CPU tensors returns the same."""
    sp, e2 = 384, 3 * 128 + 45
    arrs = parts_streams(9, 6, e2, sp)
    meta, qrank, signinq, rows = arrs
    swept = e2 // 128 * 128
    qr = qrank[:, :swept].astype(np.int64)
    si = signinq[:, :swept]
    sign = np.where(si > 0, 1, -1)
    inq = np.abs(si) == 2
    j = np.arange(sp)
    c_want = np.einsum("ne,nej->nj", np.where(~inq, sign, 0),
                       (qr[:, :, None] <= j).astype(np.int64))
    m_want = np.einsum("ne,nej->nj", np.where(inq, sign, 0),
                       (qr[:, :, None] == j).astype(np.int64))
    args = [torch.from_numpy(a) for a in arrs]
    before = l2_sweep_parts.launches
    for fn in (l2_sweep_parts_ref, l2_sweep_parts):
        planes = fn(*args, sp, mode)[2].numpy()
        assert planes.shape == (6, 2, sp) and planes.dtype == np.int32
        np.testing.assert_array_equal(
            planes[:, 0], c_want if "c" in mode else 0)
        np.testing.assert_array_equal(
            planes[:, 1], m_want if "m" in mode else 0)
    assert l2_sweep_parts.launches == before
    assert c_want.any() and m_want.any()


def test_model_config_matches_the_kernel_policy():
    """The default split fills the 132 SMs of an H100 with whole clusters
    of up to four CTAs, and R doubles only past 16 sweep warps."""
    assert model_config(56, 1152) == (2, 2, 9)  # the bench: 112 CTAs
    assert model_config(200, 1152) == (1, 4, 9)
    assert model_config(12, 1152) == (4, 1, 9)
    assert model_config(33, 256) == (4, 1, 2)
    assert model_config(1, 3968 * 4) == (4, 4, 31)
    with pytest.raises(ValueError):
        model_config(500, 3968 + 128)
    with pytest.raises(ValueError, match="splits"):
        l2_sweep_parts(*[torch.from_numpy(a) for a in
                         parts_streams(1, 4, 128, 256)], 256, "cms", splits=5)
