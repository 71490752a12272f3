"""Streaming FASTA/FASTQ reading (gzip-transparent), kseq-equivalent.

The reference uses Heng Li's kseq (src/common/kseq.h) everywhere; semantics
reproduced here:

- record name = characters up to the first whitespace after '>'/'@';
- FASTA sequences may span multiple lines; FASTQ records are 4-line;
- gzip input is detected by magic bytes.

A C++ fast path (native/) can be plugged in later behind the same generator
interface; this pure-Python version streams ~50-100 MB/s which is enough for
reads. Yields (name: str, seq: np.ndarray uint8).

Counterpart: ``metamaps_tpu/io/fasta.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple

import numpy as np


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def read_sequences(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, uint8 sequence) for each record in a FASTA/FASTQ file.

    Uses the native C++ reader (native/fastx.cpp via ctypes) when available,
    falling back to the pure-Python parser."""
    from .native import read_sequences_native

    native = read_sequences_native(path)
    if native is not None:
        yield from native
        return
    with _open_maybe_gzip(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if first == b"@":
            yield from _read_fastq(f)
        else:
            yield from _read_fasta(f)


def _read_fasta(f) -> Iterator[Tuple[str, np.ndarray]]:
    name = None
    chunks = []
    for raw in f:
        line = raw.rstrip(b"\r\n")
        if line.startswith(b">"):
            if name is not None:
                yield name, np.frombuffer(b"".join(chunks), dtype=np.uint8)
            name = line[1:].split(None, 1)[0].decode() if len(line) > 1 else ""
            chunks = []
        elif line:
            chunks.append(line)
    if name is not None:
        yield name, np.frombuffer(b"".join(chunks), dtype=np.uint8)


def _read_fastq(f) -> Iterator[Tuple[str, np.ndarray]]:
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        assert header.startswith(b"@"), f"malformed FASTQ header: {header[:50]!r}"
        name = header[1:].split(None, 1)[0].decode() if len(header) > 1 else ""
        seq = f.readline().rstrip(b"\r\n")
        plus = f.readline()
        qual = f.readline()
        assert plus.startswith(b"+"), "malformed FASTQ record (missing '+')"
        del qual
        yield name, np.frombuffer(seq, dtype=np.uint8)


def total_file_size(paths) -> int:
    """Sum of raw file sizes in bytes — the reference's referenceSize
    estimate (commonFunc.hpp:211-231 getReferenceSize)."""
    import os

    return sum(os.path.getsize(p) for p in paths)
