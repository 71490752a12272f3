"""The L2 event sweep: a hand-written CUDA kernel and its plain version.

Counterpart: ``l2_event_sweep_batch`` / ``_batch_sweep_kernel``,
``metamaps_tpu/ops/l2_pallas.py:385`` / ``:116``. The kernel source,
``metamaps_tpu_torch/csrc/l2_sweep.cu``, states the contract and design.

:func:`l2_event_sweep` takes the plain version, :func:`l2_event_sweep_ref`,
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point (loaded with ctypes) at first use, under
``build/metamaps_tpu_torch/`` beside the package.
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

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "l2_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "metamaps_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use

_lib = None
build_info = {}  # seconds and compiler report of the build in this process


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand.append(os.path.join(home, "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the L2 sweep kernel cannot be built")


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libl2_sweep_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        build_info.update(seconds=time.perf_counter() - t0,
                          report=(proc.stdout + proc.stderr).strip())
    lib = ctypes.CDLL(str(so))
    lib.l2_sweep_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.l2_sweep_launch.restype = ctypes.c_int
    lib.l2_sweep_smem_bytes.argtypes = [ctypes.c_int]
    lib.l2_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.l2_sweep_error_string.argtypes = [ctypes.c_int]
    lib.l2_sweep_error_string.restype = ctypes.c_char_p
    build_info.setdefault("library", str(so))
    _lib = lib
    return lib


def _check(meta, qrank, signinq, rows, sp: int):
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


def l2_event_sweep(meta, qrank, signinq, rows, sp: int) -> torch.Tensor:
    """Sweep every candidate's event stream (see the kernel source).

    ``meta`` [N, 4] int32 (s, row_lo, row_hi, n_ev); ``qrank``, ``signinq``,
    ``rows`` [N, E2] int32; ``sp`` the rank-plane width, a multiple of 128
    above every query rank. Returns [N, 4] int32 (best, first, last, 0).
    CPU tensors take :func:`l2_event_sweep_ref`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise."""
    _check(meta, qrank, signinq, rows, sp)
    if meta.device.type == "cpu":
        return l2_event_sweep_ref(meta, qrank, signinq, rows, sp)
    if meta.device.type != "cuda":
        raise ValueError(f"unsupported device {meta.device}")
    lib = load_library()
    smem = lib.l2_sweep_smem_bytes(sp)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sp={sp} needs {smem} B of shared memory per block "
                         f"(limit {SMEM_LIMIT})")
    n, e2 = qrank.shape
    out = torch.empty((n, 4), dtype=torch.int32, device=meta.device)
    if n == 0:
        return out
    with torch.cuda.device(meta.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.l2_sweep_launch(
            ctypes.c_void_p(meta.data_ptr()), ctypes.c_void_p(qrank.data_ptr()),
            ctypes.c_void_p(signinq.data_ptr()), ctypes.c_void_p(rows.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, e2, sp, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"l2_sweep launch failed: {lib.l2_sweep_error_string(rc).decode()}")
    l2_event_sweep.launches += 1
    return out


l2_event_sweep.launches = 0  # kernel launches since the last reset


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


def l2_event_sweep_ref(meta, qrank, signinq, rows, sp: int) -> torch.Tensor:
    """Plain PyTorch version: a Python loop over event columns with the
    candidates' [N, sp] planes updated in vectorised steps. Each candidate
    stops at its own n_ev, then closes the trailing segment."""
    dev = meta.device
    m64 = meta.to(torch.int64)
    s, row_lo, row_hi, n_ev = m64.unbind(1)
    n_ev = n_ev.clamp(0, qrank.shape[1])
    N = meta.shape[0]
    lin = torch.arange(sp, device=dev)[None, :]
    c = torch.zeros((N, sp), dtype=torch.int64, device=dev)
    m = torch.zeros_like(c)
    best = torch.zeros(N, dtype=torch.int64, device=dev)
    first = torch.full_like(best, -1)
    last = torch.full_like(best, -1)
    prev = torch.full_like(best, I32_MIN)
    shared = torch.zeros_like(best)

    def close(seg_a, seg_b, act):
        nonlocal best, first, last
        ne = act & (seg_a <= seg_b)
        better = ne & (shared > best)
        equal = ne & (shared == best) & (best > 0)
        first = torch.where(better, seg_a, first)
        last = torch.where(better | equal, seg_b, last)
        best = torch.where(better, shared, best)

    for e in range(int(n_ev.max()) if N else 0):
        act = e < n_ev
        row = rows[:, e].to(torch.int64)
        qr = qrank[:, e].to(torch.int64)[:, None]
        si = signinq[:, e].to(torch.int64)
        close(torch.maximum(prev, row_lo), torch.minimum(row - 1, row_hi), act)
        prev = torch.where(act, torch.maximum(prev, row), prev)
        sign = torch.sign(si) * act
        inq = ((si == 2) | (si == -2))[:, None]
        c += torch.where(~inq & (lin >= qr), sign[:, None], 0)
        m += torch.where(inq & (lin == qr), sign[:, None], 0)
        shared = ((m > 0) & (lin + c < s[:, None])).sum(dim=1)
    close(torch.maximum(prev, row_lo), row_hi, torch.ones_like(best, dtype=torch.bool))
    out = torch.stack([best, first, last, torch.zeros_like(best)], dim=1)
    return out.to(torch.int32)
