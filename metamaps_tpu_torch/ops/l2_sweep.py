"""The L2 event sweep: hand-written CUDA kernels and their plain version.

Four kernels compute one function, each the counterpart of one Pallas
kernel in ``metamaps_tpu/ops/l2_pallas.py`` (two of the batch kernel); their
sources under
``metamaps_tpu_torch/csrc/`` state the contract and design:

- :func:`l2_event_sweep_batch` (``csrc/l2_sweep.cu``): ``l2_event_sweep_batch``
  / ``_batch_sweep_kernel``, the mapping path's sweep; one warp per
  candidate, O(1) work per event while the count has its prefix form, the
  rank planes in shared memory up to ``BATCH_SP_MAX``; wider planes go to
  :func:`l2_event_sweep_wide` (``csrc/l2_sweep_wide.cu``), the same chain
  with its planes in device memory, each candidate's events split into
  chunks that many warps sweep at once from start states built by prefix
  sums (:func:`l2_event_sweep_split_ref` is that decomposition in plain
  PyTorch);
- :func:`l2_event_sweep_rb` (``csrc/l2_sweep_rb.cu``): ``l2_event_sweep_rb``
  / ``_rb_sweep_kernel``; the same chain, 8 candidates to a block, int16
  planes;
- :func:`l2_event_sweep` (``csrc/l2_sweep_eager.cu``): ``l2_event_sweep`` /
  ``_sweep_kernel``, which scores each segment eagerly after its event; one
  block per candidate, the chain on one lane, the recount over the block.

Each wrapper takes the plain version, :func:`l2_event_sweep_ref`, only for
CPU tensors; for CUDA tensors it launches its kernel or raises, and counts
the launch. The sources (with ``csrc/l2_sweep_parts.cu``, the ablation, and
``csrc/sketch.cu``, the read sketch of ``ops/sketch.py``) are compiled at
first use into one shared library with plain C entry points,
loaded with ctypes, under ``build/metamaps_tpu_torch/`` beside the package:
one ``nvcc -c`` for ``sm_90a`` per source, all started together, then one
link (:func:`load_library`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "metamaps_tpu_torch"
SOURCES = ("l2_sweep", "l2_sweep_wide", "l2_sweep_rb", "l2_sweep_eager",
           "l2_sweep_parts", "sketch")
HEADERS = ("l2_sweep_common.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use
INT16_MAX_E2 = 2**15 - 1  # events per candidate that int16 rank planes hold
TILE_EVENTS = 64  # events per staged tile (``TILE``, csrc/l2_sweep_common.cuh)
#: the widest plane the batch kernel keeps in shared memory: one warp needs
#: (2 * sp + 8 * TILE_EVENTS) * 4 bytes (``warp_smem_bytes``,
#: csrc/l2_sweep.cu), at most SMEM_LIMIT with one warp to a block, so
#: sp <= 28800 (sketches up to 28,799 hashes: sp = round_up(sc + 1, 128) in
#: ``ops/l2.py``). :func:`l2_event_sweep_batch` sweeps wider planes with
#: :func:`l2_event_sweep_wide`.
BATCH_SP_MAX = (SMEM_LIMIT - 8 * TILE_EVENTS * 4) // 8 // 128 * 128
_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of each source's ``<name>_launch``
LAUNCH_ARGS = {
    "l2_sweep": [_P] * 5 + [_I] * 3 + [_P],  # meta..out, n, e2, sp, stream
    # meta..out, ws, aux, n, e2, sp, L, P, W, G, stream
    "l2_sweep_wide": [_P] * 7 + [_I] * 7 + [_P],
    "l2_sweep_rb": [_P] * 5 + [_I] * 3 + [_P],
    "l2_sweep_eager": [_P] * 5 + [_I] * 3 + [_P],
    # meta..out, fold, planes, n, e2, sp, splits, mode bits, stream
    "l2_sweep_parts": [_P] * 7 + [_I] * 5 + [_P],
    # reads, lens, B, L, k, w, S, alpha4, kcap, rb, ws, gring..ovf, stream
    # (ops/sketch.py)
    "sketch": [_P] * 2 + [_I] * 8 + [_P] * 7,
}
#: the wide kernel's workspace (``ws`` in csrc/l2_sweep_wide.cu) at most,
#: in bytes, beyond one chunk's planes
WIDE_WORKSPACE_CAP = 256 * 2**20
#: chunks a slab of the wide kernel aims at per SM, and events per chunk at
#: least (a chunk pays one pass over its planes before its chain). One
#: chunk per SM keeps the chains' planes in L2 at the long read's width
#: (132 chunks of 246,784 B); two per SM doubled the chain's cost per
#: event on an H100 (PERF.md)
WIDE_CHUNKS_PER_SM = 1
WIDE_MIN_CHUNK_EVENTS = 512
#: the sources whose blocks' shared memory follows from sp alone
SMEM_BYTES = ("l2_sweep", "l2_sweep_rb", "l2_sweep_eager")

_lib = None
build_info: dict = {}  # the library's path; seconds and compiler report of its build


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand.append(os.path.join(home, "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds) -> str:
    """Start every command at once, wait for all; return their output, or
    raise with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")
    return "".join(outs)


def _build() -> Path:
    """Compile and link the kernel library unless this version of its
    sources is built."""
    blob = b"".join((CSRC / f).read_bytes()
                    for f in [f"{n}.cu" for n in SOURCES] + list(HEADERS))
    digest = hashlib.sha1(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libl2_sweep_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest}.{os.getpid()}"
        objs = [BUILD_DIR / f"{n}_{tag}.o" for n in SOURCES]
        t0 = time.perf_counter()
        report = _run_all(
            [[_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o),
              str(CSRC / f"{n}.cu")] for n, o in zip(SOURCES, objs)])
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        report += _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                             *map(str, objs)]])
        os.replace(tmp, so)
        for o in objs:
            o.unlink()
        build_info.update(seconds=time.perf_counter() - t0,
                          report=report.strip())
    build_info["library"] = str(so)
    return so


def load_library() -> ctypes.CDLL:
    """Build (once per version of the sources) and load the kernel library.
    Its C interface, for each source name: ``<name>_launch`` (pointers,
    ints, stream; returns a CUDA error code); ``<name>_smem_bytes(sp)`` for
    the names in ``SMEM_BYTES``; ``l2_sweep_parts_config(n, sp, splits,
    int[4])``; and ``l2_sweep_error_string(code)``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, args in LAUNCH_ARGS.items():
            getattr(lib, f"{name}_launch").argtypes = args
            getattr(lib, f"{name}_launch").restype = ctypes.c_int
        for name in SMEM_BYTES:
            getattr(lib, f"{name}_smem_bytes").argtypes = [ctypes.c_int]
            getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_longlong
        lib.l2_sweep_parts_config.argtypes = [_I, _I, _I, _P]
        lib.l2_sweep_parts_config.restype = ctypes.c_int
        lib.l2_sweep_error_string.argtypes = [ctypes.c_int]
        lib.l2_sweep_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(name: str, sp: int) -> int:
    """Dynamic shared memory of one block of kernel ``name`` at width ``sp``;
    raises ``ValueError`` above what a Hopper block may use."""
    smem = getattr(load_library(), f"{name}_smem_bytes")(sp)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sp={sp} needs {smem} B of shared memory per block "
                         f"(limit {SMEM_LIMIT})")
    return smem


def launch(name: str, device, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``device``'s current stream
    and raise on a non-zero CUDA error code. ``args`` are ctypes values."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"{name}_launch")(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.l2_sweep_error_string(rc).decode()}")


def check_sweep_args(meta, qrank, signinq, rows, sp: int):
    """Device, type, shape and contiguity checks shared by the sweep
    wrappers: meta [N, 4], qrank / signinq / rows [N, E2], all int32 on one
    device and contiguous; ``sp`` a positive multiple of 128."""
    if meta.dim() != 2 or meta.shape[1] != 4:
        raise ValueError(f"meta must be [N, 4], got {tuple(meta.shape)}")
    n = meta.shape[0]
    for name, t in (("qrank", qrank), ("signinq", signinq), ("rows", rows)):
        if t.dim() != 2 or t.shape != qrank.shape or t.shape[0] != n:
            raise ValueError(f"{name} must be [N, E2] like qrank, got "
                             f"{tuple(t.shape)}")
    for name, t in (("meta", meta), ("qrank", qrank), ("signinq", signinq),
                    ("rows", rows)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != meta.device:
            raise ValueError(f"{name} is on {t.device}, meta on {meta.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sp <= 0 or sp % 128:
        raise ValueError(f"sp must be a positive multiple of 128, got {sp}")
    if meta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {meta.device}")


def _sweep(wrapper, name: str, meta, qrank, signinq, rows, sp: int,
           max_e2: int = None):
    """Launch the sweep kernel ``name`` on CUDA tensors (checked) and count
    the launch on ``wrapper``; N = 0 launches nothing. A kernel whose planes
    hold at most ``max_e2`` events raises ``ValueError`` above that."""
    smem_bytes(name, sp)
    n, e2 = qrank.shape
    if max_e2 is not None and e2 > max_e2:
        raise ValueError(f"E2={e2} events per candidate: {name} keeps int16 "
                         f"rank planes, which hold at most {max_e2}")
    out = torch.empty((n, 4), dtype=torch.int32, device=meta.device)
    if n == 0:
        return out
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    launch(name, meta.device, ptr(meta), ptr(qrank), ptr(signinq), ptr(rows),
           ptr(out), ctypes.c_int(n), ctypes.c_int(e2), ctypes.c_int(sp))
    wrapper.launches += 1
    return out


def l2_event_sweep_batch(meta, qrank, signinq, rows, sp: int) -> torch.Tensor:
    """Sweep every candidate's event stream (``csrc/l2_sweep.cu``).

    ``meta`` [N, 4] int32 (s, row_lo, row_hi, n_ev); ``qrank``, ``signinq``,
    ``rows`` [N, E2] int32; ``sp`` the rank-plane width, a multiple of 128
    above every query rank. Returns [N, 4] int32 (best, first, last, 0).
    CPU tensors take :func:`l2_event_sweep_ref`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise. Above
    ``BATCH_SP_MAX`` the planes do not fit shared memory, and every device
    hands the sweep to :func:`l2_event_sweep_wide`."""
    if sp > BATCH_SP_MAX:
        return l2_event_sweep_wide(meta, qrank, signinq, rows, sp)
    check_sweep_args(meta, qrank, signinq, rows, sp)
    if meta.device.type == "cpu":
        return l2_event_sweep_ref(meta, qrank, signinq, rows, sp)
    return _sweep(l2_event_sweep_batch, "l2_sweep", meta, qrank, signinq,
                  rows, sp)


def wide_plan(n: int, e2: int, sp: int, sms: int, chunk_events=None):
    """How :func:`l2_event_sweep_wide` cuts its work: (L events per chunk,
    P chunks per candidate, W chunks per window, G candidates per group).

    By default L cuts the N x E2 event slots into at most
    ``WIDE_CHUNKS_PER_SM`` chunks per SM of the card's ``sms``, a multiple
    of the 64-event tile, at least ``WIDE_MIN_CHUNK_EVENTS``;
    ``chunk_events`` forces it. L is at most E2, so that P = ceil(E2 / L)
    >= 1. The workspace holds W chunks' planes (8 * sp bytes each) for G
    candidates, at most ``WIDE_WORKSPACE_CAP`` bytes: every chunk of every
    candidate at once where that fits, else groups of candidates with all
    their chunks, else one candidate in windows of chunks (at least one
    chunk, whatever its size)."""
    if chunk_events is None:
        per = -(-n * e2 // (WIDE_CHUNKS_PER_SM * max(sms, 1)))
        L = max(WIDE_MIN_CHUNK_EVENTS, -(-per // TILE_EVENTS) * TILE_EVENTS)
    else:
        L = int(chunk_events)
        if L < 1:
            raise ValueError(f"chunk_events must be >= 1, got {chunk_events}")
    L = min(L, max(e2, 1))
    P = max(1, -(-e2 // L))
    slot = 8 * sp  # one chunk's r and M planes, int32
    cap = WIDE_WORKSPACE_CAP
    if n * P * slot <= cap:
        W, G = P, n
    elif P * slot <= cap:
        W, G = P, cap // (P * slot)
    else:
        W, G = max(1, min(P, cap // slot)), 1
    return L, P, W, max(1, min(G, n, 65535))  # G is a grid's y extent


def l2_event_sweep_wide(meta, qrank, signinq, rows, sp: int,
                        chunk_events=None) -> torch.Tensor:
    """The same function as :func:`l2_event_sweep_batch`, with the rank
    planes in device memory (``csrc/l2_sweep_wide.cu``): any ``sp``. Each
    candidate's events are cut into chunks of L events (:func:`wide_plan`;
    ``chunk_events`` forces L, for tests and benches), which are swept at
    once, each from its start planes (the prefix sums of the chunks'
    deltas before it); their folds combine in chunk order. The workspace
    is int32 [G, W, 2, sp], at most ``WIDE_WORKSPACE_CAP`` (256 MiB) beyond
    one chunk's planes: above it the candidates are swept in groups, and a
    candidate's chunks in windows. CPU tensors take
    :func:`l2_event_sweep_ref`; CUDA tensors launch the kernels or raise,
    and count one launch per call."""
    check_sweep_args(meta, qrank, signinq, rows, sp)
    n, e2 = qrank.shape
    sms = (torch.cuda.get_device_properties(meta.device).multi_processor_count
           if meta.device.type == "cuda" else 1)
    L, P, W, G = wide_plan(n, e2, sp, sms, chunk_events)
    if meta.device.type == "cpu":
        return l2_event_sweep_ref(meta, qrank, signinq, rows, sp)
    out = torch.empty((n, 4), dtype=torch.int32, device=meta.device)
    if n == 0:
        return out
    ws = torch.empty((G, W, 2, sp), dtype=torch.int32, device=meta.device)
    aux = torch.empty((G, P, 8), dtype=torch.int32, device=meta.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    launch("l2_sweep_wide", meta.device, ptr(meta), ptr(qrank), ptr(signinq),
           ptr(rows), ptr(out), ptr(ws), ptr(aux),
           *map(ctypes.c_int, (n, e2, sp, L, P, W, G)))
    l2_event_sweep_wide.launches += 1
    return out


def l2_event_sweep_rb(meta, qrank, signinq, rows, sp: int) -> torch.Tensor:
    """The same function as :func:`l2_event_sweep_batch`, one warp per
    candidate, 8 to a block (``csrc/l2_sweep_rb.cu``). Its int16 planes and
    event tiles take 32 * sp + 16384 bytes of shared memory per block, so
    ``sp`` is at most 6656, and E2 at most 32767; on CUDA tensors it raises
    ``ValueError`` above either."""
    check_sweep_args(meta, qrank, signinq, rows, sp)
    if meta.device.type == "cpu":
        return l2_event_sweep_ref(meta, qrank, signinq, rows, sp)
    return _sweep(l2_event_sweep_rb, "l2_sweep_rb", meta, qrank, signinq,
                  rows, sp, max_e2=INT16_MAX_E2)


def l2_event_sweep(meta, qrank, signinq, rows, s_pad: int) -> torch.Tensor:
    """The same function as :func:`l2_event_sweep_batch`, evaluated eagerly
    after each event (``csrc/l2_sweep_eager.cu``). ``s_pad``, the plane
    width, must be a multiple of 1024, as in the JAX kernel; on CUDA tensors
    E2 is at most 32767 (int16 planes), or it raises ``ValueError``."""
    if s_pad <= 0 or s_pad % 1024:
        raise ValueError(f"s_pad must be a positive multiple of 1024, got {s_pad}")
    check_sweep_args(meta, qrank, signinq, rows, s_pad)
    if meta.device.type == "cpu":
        return l2_event_sweep_ref(meta, qrank, signinq, rows, s_pad)
    return _sweep(l2_event_sweep, "l2_sweep_eager", meta, qrank, signinq,
                  rows, s_pad, max_e2=INT16_MAX_E2)


# kernel launches since the last reset
l2_event_sweep_batch.launches = 0
l2_event_sweep_wide.launches = 0
l2_event_sweep_rb.launches = 0
l2_event_sweep.launches = 0


def random_event_streams(rng, n: int, e2: int, sc: int, row_span: int = 400):
    """Event streams that obey the sweep's contract, as numpy int32 arrays
    (meta, qrank, signinq, rows), for holding the kernel against its plain
    version: ascending rows with ties, signs in {0, +-1, +-2}, empty
    candidates, row_lo > row_hi, and after the real events either padding
    only or one non-zero-sign event at row INT32_MAX (what the setup emits
    for the last window occurrence). Query ranks lie in [0, sc]."""
    import numpy as np

    meta = np.zeros((n, 4), np.int32)
    qrank = np.zeros((n, e2), np.int32)
    signinq = np.zeros((n, e2), np.int32)
    rows = np.full((n, e2), I32_MAX, np.int32)
    for i in range(n):
        ne = 0 if i % 7 == 0 else int(rng.integers(1, e2 + 1))
        rows[i, :ne] = np.sort(rng.integers(-60, row_span, ne))
        signinq[i, :ne] = rng.choice([-2, -1, 0, 1, 2], ne)
        qrank[i, :ne] = rng.integers(0, sc + 1, ne)
        if i % 3 == 1 and ne < e2:
            signinq[i, ne] = rng.choice([-2, -1, 1, 2])
            qrank[i, ne] = rng.integers(0, sc)
        lo = int(rng.integers(-80, row_span))
        hi = int(rng.integers(-80, row_span + 40))
        meta[i] = (int(rng.integers(0, sc + 1)), lo, hi, ne)
    return meta, qrank, signinq, rows


def paired_event_streams(rng, n: int, e2: int, sc: int, flip: float = 0.0,
                         row_span: int = 400):
    """Event streams shaped like the setup's, as numpy int32 arrays (meta,
    qrank, signinq, rows): each occurrence adds its base (1 ref-only, 2
    in-query) at one row and removes it at the same or a later row, ranks in
    [0, sc], rows ascending with adds before removals on equal rows. No
    rank's ref-only multiplicity then goes negative, so the batch kernel
    stays in its incremental mode. With ``flip`` > 0 that share of the
    ref-only occurrences removes first and adds back later: a rank goes
    negative and recovers (the kernel's recount mode, and back). Like
    :func:`random_event_streams`: empty candidates, padding after n_ev, a
    non-zero-sign event at row INT32_MAX past n_ev on every third
    candidate, and row_lo > row_hi on some."""
    import numpy as np

    meta = np.zeros((n, 4), np.int32)
    qrank = np.zeros((n, e2), np.int32)
    signinq = np.zeros((n, e2), np.int32)
    rows = np.full((n, e2), I32_MAX, np.int32)
    for i in range(n):
        k = 0 if i % 7 == 0 else int(rng.integers(1, e2 // 2 + 1))
        ne = 2 * k
        rows[i, :ne], signinq[i, :ne], qrank[i, :ne] = _pairs(
            rng, k, sc, flip, row_span)
        if i % 3 == 1 and ne < e2:
            signinq[i, ne] = -rng.choice([1, 2])
            qrank[i, ne] = rng.integers(0, sc)
        lo = int(rng.integers(-80, row_span))
        hi = int(rng.integers(-80, row_span + 40))
        meta[i] = (int(rng.integers(0, sc + 1)), lo, hi, ne)
    return meta, qrank, signinq, rows


def _close(fold, shared, seg_a, seg_b, act):
    """Fold the segments [seg_a, seg_b] (where ``act`` and not empty), each
    scored with its candidate's count ``shared``, onto ``fold`` = (best,
    first, last): ">" sets first and last, "==" with best > 0 extends
    last."""
    best, first, last = fold
    ne = act & (seg_a <= seg_b)
    better = ne & (shared > best)
    equal = ne & (shared == best) & (best > 0)
    return (torch.where(better, shared, best),
            torch.where(better, seg_a, first),
            torch.where(better | equal, seg_b, last))


def _combine(fold, later):
    """The fold of a later run of segments onto an earlier run's, each
    folded from (0, -1, -1)."""
    (best, first, last), (b_best, b_first, b_last) = fold, later
    better = b_best > best
    equal = (b_best == best) & (b_best > 0)
    return (torch.where(better, b_best, best),
            torch.where(better, b_first, first),
            torch.where(better | equal, b_last, last))


def _sweep_from(s, row_lo, row_hi, n_ev, qrank, signinq, rows, c, m, prev):
    """The plain sweep of each row's first ``n_ev`` events (int64 [N]
    vectors) from the state (C plane ``c``, M plane ``m``, [N, sp] int64,
    updated in place; ``prev`` the highest row before the events): the fold
    from (0, -1, -1) of the segments that close before the events, then
    the count and the highest row after them. Nothing is closed after the
    last event."""
    dev = c.device
    lin = torch.arange(c.shape[1], device=dev)[None, :]
    shared = ((m > 0) & (lin + c < s[:, None])).sum(dim=1)
    fold = (torch.zeros_like(s), torch.full_like(s, -1),
            torch.full_like(s, -1))
    for e in range(int(n_ev.max()) if n_ev.numel() else 0):
        act = e < n_ev
        row = rows[:, e].to(torch.int64)
        qr = qrank[:, e].to(torch.int64)[:, None]
        si = signinq[:, e].to(torch.int64)
        fold = _close(fold, shared, torch.maximum(prev, row_lo),
                      torch.minimum(row - 1, row_hi), act)
        prev = torch.where(act, torch.maximum(prev, row), prev)
        sign = torch.sign(si) * act
        inq = ((si == 2) | (si == -2))[:, None]
        c += torch.where(~inq & (lin >= qr), sign[:, None], 0)
        m += torch.where(inq & (lin == qr), sign[:, None], 0)
        shared = ((m > 0) & (lin + c < s[:, None])).sum(dim=1)
    return fold, shared, prev


def _pairs(rng, k: int, sc: int, flip: float, row_span: int):
    """k occurrences' add and removal events, sorted by row with adds first
    on ties: (rows, signinq, qrank) numpy arrays of 2k events."""
    import numpy as np

    q = rng.integers(0, sc + 1, k)
    base = rng.choice([1, 2], k)
    flipped = (base == 1) & (rng.random(k) < flip)
    add = np.where(flipped, -base, base)
    at = rng.integers(-60, row_span, k)
    until = at + rng.integers(0, row_span // 4 + 1, k)
    ev_row = np.concatenate([at, until])
    order = np.lexsort((np.repeat([0, 1], k), ev_row))  # adds first on ties
    return (ev_row[order], np.concatenate([add, -add])[order],
            np.concatenate([q, q])[order])


def long_event_stream(rng, e2: int, sc: int, flip: float = 0.0,
                      row_span: int = None):
    """One candidate of E2 setup-shaped events, as numpy int32 arrays
    (meta, qrank, signinq, rows) of one row each: the occurrences of
    :func:`paired_event_streams`, E2 // 2 of them, every event real, rows
    over ``row_span`` (E2 by default) so that a slab has the long read's
    shape; ``flip`` as there; s = sc // 2 and the rows scored all."""
    import numpy as np

    k = e2 // 2
    qrank = np.zeros((1, e2), np.int32)
    signinq = np.zeros((1, e2), np.int32)
    rows = np.full((1, e2), I32_MAX, np.int32)
    span = e2 if row_span is None else row_span
    rows[0, :2 * k], signinq[0, :2 * k], qrank[0, :2 * k] = _pairs(
        rng, k, sc, flip, span)
    meta = np.array([[sc // 2, -60, span + span // 4, 2 * k]], np.int32)
    return meta, qrank, signinq, rows


def l2_event_sweep_ref(meta, qrank, signinq, rows, sp: int) -> torch.Tensor:
    """Plain PyTorch version: a Python loop over event columns with the
    candidates' [N, sp] planes updated in vectorised steps. Each candidate
    stops at its own n_ev, then closes the trailing segment."""
    m64 = meta.to(torch.int64)
    s, row_lo, row_hi, n_ev = m64.unbind(1)
    n_ev = n_ev.clamp(0, qrank.shape[1])
    c = torch.zeros((meta.shape[0], sp), dtype=torch.int64, device=meta.device)
    fold, shared, prev = _sweep_from(s, row_lo, row_hi, n_ev, qrank, signinq,
                                     rows, c, torch.zeros_like(c),
                                     torch.full_like(s, I32_MIN))
    best, first, last = _close(fold, shared, torch.maximum(prev, row_lo),
                               row_hi, torch.ones_like(s, dtype=torch.bool))
    out = torch.stack([best, first, last, torch.zeros_like(best)], dim=1)
    return out.to(torch.int32)


def l2_event_sweep_split_ref(meta, qrank, signinq, rows, sp: int,
                             chunk_events: int) -> torch.Tensor:
    """The wide kernel's decomposition (``csrc/l2_sweep_wide.cu``) in plain
    PyTorch, for tests and for finding where a kernel goes wrong; no
    wrapper calls it. Each candidate's events are cut into chunks of L =
    ``chunk_events`` (at most E2); each chunk's deltas to the r and M
    planes are summed over the chunks before it (its start planes, C the
    prefix of r), its start row is the highest row before it, and the plain
    sweep runs every chunk at once from its state (L steps instead of E2).
    The chunks' folds combine in chunk order, and the last chunk's count
    and highest row close the trailing segment. Equals
    :func:`l2_event_sweep_ref` for every L."""
    n, e2 = qrank.shape
    dev = meta.device
    L = max(1, min(int(chunk_events), max(e2, 1)))
    P = max(1, -(-e2 // L))
    m64 = meta.to(torch.int64)
    s, row_lo, row_hi, n_ev = m64.unbind(1)
    n_ev = n_ev.clamp(0, e2)

    def chunked(t, fill):  # [N, E2] -> [N, P, L], padded past E2
        t = torch.nn.functional.pad(t.to(torch.int64), (0, P * L - e2),
                                    value=fill)
        return t.view(n, P, L)

    q, si, rw = chunked(qrank, 0), chunked(signinq, 0), chunked(rows, I32_MAX)
    live = torch.arange(P * L, device=dev).view(1, P, L) < n_ev[:, None, None]
    sign = torch.sign(si) * live
    inq = (si == 2) | (si == -2)
    # each chunk's deltas, as multiplicities at one rank (plane index sp
    # takes the events that act on no rank)
    ref_rank = torch.where(~inq & (q < sp), q.clamp(min=0), sp)
    inq_rank = torch.where(inq & (q >= 0) & (q < sp), q, sp)
    chunk_of = torch.arange(n * P, device=dev).view(n, P, 1) * (sp + 1)
    r = torch.zeros(n * P * (sp + 1), dtype=torch.int64, device=dev)
    m = torch.zeros_like(r)
    r.index_add_(0, (chunk_of + ref_rank).flatten(),
                 (sign * ~inq).flatten())
    m.index_add_(0, (chunk_of + inq_rank).flatten(), (sign * inq).flatten())
    r = r.view(n, P, sp + 1)[..., :sp]
    m = m.view(n, P, sp + 1)[..., :sp]
    # start planes: the exclusive sum of the deltas over the chunks before
    r0 = r.cumsum(dim=1) - r
    m0 = m.cumsum(dim=1) - m
    c0 = r0.cumsum(dim=2)
    high = torch.where(live, rw, I32_MIN).amax(dim=2)  # per chunk
    prev0 = torch.cat([torch.full((n, 1), I32_MIN, dtype=torch.int64,
                                  device=dev),
                       high.cummax(dim=1).values[:, :-1]], dim=1)
    # every chunk's sweep from its state, as one candidate each
    rep = lambda v: v[:, None].expand(n, P).reshape(-1)
    n_ev_chunk = (n_ev[:, None] - torch.arange(P, device=dev)[None, :] * L
                  ).clamp(0, L).reshape(-1)
    fold, shared, prev = _sweep_from(
        rep(s), rep(row_lo), rep(row_hi), n_ev_chunk, q.view(n * P, L),
        si.view(n * P, L), rw.view(n * P, L), c0.reshape(n * P, sp),
        m0.reshape(n * P, sp), prev0.reshape(-1))
    fold = [f.view(n, P) for f in fold]
    acc = (torch.zeros_like(s), torch.full_like(s, -1), torch.full_like(s, -1))
    for p in range(P):  # chunk order; a chunk past n_ev folds nothing
        acc = _combine(acc, tuple(f[:, p] for f in fold))
    # the last chunk's carries: those of the last real one
    best, first, last = _close(
        acc, shared.view(n, P)[:, -1],
        torch.maximum(prev.view(n, P)[:, -1], row_lo), row_hi,
        torch.ones_like(s, dtype=torch.bool))
    out = torch.stack([best, first, last, torch.zeros_like(best)], dim=1)
    return out.to(torch.int32)
