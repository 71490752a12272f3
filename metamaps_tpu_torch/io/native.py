"""ctypes bindings for the native C++ FASTA/FASTQ reader, mapping-file
parser and winnower (``native/fastx.cpp``, ``native/mapq_parse.cpp``,
``native/winnow.cpp`` at the root of the repository).

Counterpart: ``metamaps_tpu/io/native.py``. Each shared library is built
with g++ on first use from the repository's sources into
``build/metamaps_tpu_torch/`` (never beside the sources) and rebuilt when
its source is newer. When the toolchain or zlib headers are unavailable the
callers fall back silently to their numpy / pure-Python versions.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_BUILD_DIR = os.path.join(_ROOT, "build", "metamaps_tpu_torch")


def _compile(src_name: str, so_name: str, flags, libs=()) -> Optional[str]:
    """Path of the up-to-date shared library built from ``native/src_name``,
    or None when the source is missing. Raises when g++ fails."""
    src = os.path.join(_ROOT, "native", src_name)
    if not os.path.exists(src):
        return None
    so = os.path.join(_BUILD_DIR, so_name)
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", tmp, src,
                        *libs], check=True, capture_output=True)
        os.replace(tmp, so)
    return so


_LIB = None
_TRIED = False


class _FastxData(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("names", ctypes.c_char_p),
        ("name_off", ctypes.POINTER(ctypes.c_int64)),
        ("n", ctypes.c_int64),
    ]


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = _compile("fastx.cpp", "libfastx.so", ["-O2"], ["-lz"])
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.fastx_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FastxData)]
        lib.fastx_read.restype = ctypes.c_int
        lib.fastx_free.argtypes = [ctypes.POINTER(_FastxData)]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


# --- mapping-file parser (native/mapq_parse.cpp) ----------------------------

_MAPQ_LIB = None
_MAPQ_TRIED = False


class _MapqData(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.POINTER(ctypes.c_char)),
        ("buf_len", ctypes.c_int64),
        ("n_lines", ctypes.c_int64),
        ("n_reads", ctypes.c_int64),
        ("n_contigs", ctypes.c_int64),
        ("line_beg", ctypes.POINTER(ctypes.c_int64)),
        ("line_end", ctypes.POINTER(ctypes.c_int64)),
        ("read_of_line", ctypes.POINTER(ctypes.c_int64)),
        ("contig_idx", ctypes.POINTER(ctypes.c_int32)),
        ("read_len", ctypes.POINTER(ctypes.c_int64)),
        ("start", ctypes.POINTER(ctypes.c_int64)),
        ("stop", ctypes.POINTER(ctypes.c_int64)),
        ("identity", ctypes.POINTER(ctypes.c_double)),
        ("mapq", ctypes.POINTER(ctypes.c_double)),
        ("contig_beg", ctypes.POINTER(ctypes.c_int64)),
        ("contig_end", ctypes.POINTER(ctypes.c_int64)),
        ("read_id_beg", ctypes.POINTER(ctypes.c_int64)),
        ("read_id_end", ctypes.POINTER(ctypes.c_int64)),
    ]


def _build_and_load_mapq() -> Optional[ctypes.CDLL]:
    global _MAPQ_LIB, _MAPQ_TRIED
    if _MAPQ_TRIED:
        return _MAPQ_LIB
    _MAPQ_TRIED = True
    try:
        so = _compile("mapq_parse.cpp", "libmapqparse.so", ["-O2"])
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.mapq_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MapqData)]
        lib.mapq_parse.restype = ctypes.c_int
        lib.mapq_free.argtypes = [ctypes.POINTER(_MapqData)]
        _MAPQ_LIB = lib
    except Exception:
        _MAPQ_LIB = None
    return _MAPQ_LIB


def parse_mappings_native(path: str):
    """Columnar parse of a mapping-qualities file. Returns a dict of numpy
    columns + decoded strings, or None when the native library is
    unavailable or the file isn't a clean 14-field file (caller falls back
    to the Python parser, which raises the right errors)."""
    lib = _build_and_load_mapq()
    if lib is None:
        return None
    data = _MapqData()
    rc = lib.mapq_parse(path.encode(), ctypes.byref(data))
    if rc != 0:
        return None  # rc=1 open failure / rc>=2 malformed — Python path decides
    try:
        n, r, c = int(data.n_lines), int(data.n_reads), int(data.n_contigs)

        def arr(ptr, count, copy=True):
            if count == 0:
                return np.empty(0, np.ctypeslib.as_array(ptr, shape=(1,)).dtype)
            a = np.ctypeslib.as_array(ptr, shape=(count,))
            return a.copy() if copy else a

        cols = {
            "read_of_line": arr(data.read_of_line, n),
            "contig_idx": arr(data.contig_idx, n),
            "read_len": arr(data.read_len, n),
            "start": arr(data.start, n),
            "stop": arr(data.stop, n),
            "identity": arr(data.identity, n),
            "mapq": arr(data.mapq, n),
        }
        text = ctypes.string_at(data.buf, data.buf_len).decode("latin-1")
        lb, le = arr(data.line_beg, n).tolist(), arr(data.line_end, n).tolist()
        cols["lines"] = [text[b:e] for b, e in zip(lb, le)]
        cb, ce = arr(data.contig_beg, c).tolist(), arr(data.contig_end, c).tolist()
        cols["contigs"] = [text[b:e] for b, e in zip(cb, ce)]
        rb, re_ = arr(data.read_id_beg, r).tolist(), arr(data.read_id_end, r).tolist()
        cols["read_ids"] = [text[b:e] for b, e in zip(rb, re_)]
    finally:
        lib.mapq_free(ctypes.byref(data))
    return cols


# --- native winnower (native/winnow.cpp) ------------------------------------

_WINNOW_LIB = None
_WINNOW_TRIED = False
_WINNOW_LOCK = threading.Lock()


def _build_and_load_winnow() -> Optional[ctypes.CDLL]:
    # first touch may come from several winnowing threads at once
    if _WINNOW_TRIED:
        return _WINNOW_LIB
    with _WINNOW_LOCK:
        return _build_and_load_winnow_locked()


def _build_and_load_winnow_locked() -> Optional[ctypes.CDLL]:
    global _WINNOW_LIB, _WINNOW_TRIED
    if _WINNOW_TRIED:
        return _WINNOW_LIB
    try:
        so = _compile("winnow.cpp", "libwinnow.so", ["-O3"])
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.winnow.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int8),
        ]
        lib.winnow.restype = ctypes.c_int64
        _WINNOW_LIB = lib
    except Exception:
        _WINNOW_LIB = None
    finally:
        # only once the attempt is over: a thread that saw the flag
        # earlier took the unlocked path and the numpy winnower
        _WINNOW_TRIED = True
    return _WINNOW_LIB


def winnow_native(seq: np.ndarray, k: int, w: int, alphabet_size: int = 4):
    """Native deque winnowing (bit-exact with ops.winnow.winnow_oracle);
    returns (hash u32, wpos i32, strand i8) or None when the native
    toolchain is unavailable. Releases the GIL — callers may thread over
    contigs."""
    lib = _build_and_load_winnow()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, np.uint8)
    n = len(seq)
    cap = max(1, n)
    out_h = np.empty(cap, np.uint32)
    out_p = np.empty(cap, np.int32)
    out_s = np.empty(cap, np.int8)
    count = lib.winnow(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int(k), ctypes.c_int(w),
        ctypes.c_int(alphabet_size),
        out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return out_h[:count].copy(), out_p[:count].copy(), out_s[:count].copy()


def read_sequences_native(path: str) -> Optional[Iterator[Tuple[str, np.ndarray]]]:
    """Parse the whole file natively; returns None when unavailable so the
    caller can fall back to the Python reader."""
    lib = _build_and_load()
    if lib is None:
        return None
    data = _FastxData()
    rc = lib.fastx_read(path.encode(), ctypes.byref(data))
    if rc != 0:
        if rc != 1:
            lib.fastx_free(ctypes.byref(data))
        raise RuntimeError(f"native fastx parse failed (code {rc}) for {path}")
    try:
        n = data.n
        seq_off = np.ctypeslib.as_array(data.seq_off, shape=(n + 1,)).copy()
        total = int(seq_off[-1])
        seq = np.ctypeslib.as_array(data.seq, shape=(max(total, 1),))[:total].copy()
        name_off = np.ctypeslib.as_array(data.name_off, shape=(n + 1,)).copy()
        names_blob = ctypes.string_at(data.names, int(name_off[-1]))
    finally:
        lib.fastx_free(ctypes.byref(data))

    def gen():
        for i in range(n):
            name = names_blob[name_off[i] : name_off[i + 1]].decode()
            yield name, seq[seq_off[i] : seq_off[i + 1]]

    return gen()
