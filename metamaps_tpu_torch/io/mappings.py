"""The mappings-file contract and its sidecars.

One line per (read, candidate location), space-separated (reference:
computeMap.hpp:565-581 for fields 1-12, mapWrap.h:318-320 for 13-14):

  1 readID   2 readLen   3 qStart(0)   4 qEnd(readLen-1)   5 strand(+/-)
  6 contigID 7 contigLen 8 refStart    9 refEnd           10 identity(%%)
 11 minHashIntersection  12 sketchSize
 13 correctedIdentity(%%) 14 mappingQuality            (added after merge)

Sidecars: ``<out>.meta`` (read counts, mapWrap.h:178-184),
``<out>.meta.unmappedReadsLengths`` (mapWrap.h:96-139),
``<out>.parameters`` (mapWrap.h:196-211).

Floats are printed like C++ ``ostream <<`` (6 significant digits, %g).

Counterpart: ``metamaps_tpu/io/mappings.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List

import numpy as np


def fmt_g(x) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return "%.6g" % float(x)


@dataclass
class MappingLine:
    read_id: str
    read_len: int
    strand: int  # +1/-1
    contig_id: str
    contig_len: int
    ref_start: int
    ref_end: int
    identity: float  # percent
    intersection: int
    sketch_size: int
    corrected_identity: float = None  # percent, field 13
    mapq: float = None  # field 14

    def format(self) -> str:
        parts = [
            self.read_id,
            str(self.read_len),
            "0",
            str(self.read_len - 1),
            "+" if self.strand > 0 else "-",
            self.contig_id,
            str(self.contig_len),
            str(self.ref_start),
            str(self.ref_end),
            fmt_g(self.identity),
            str(self.intersection),
            str(self.sketch_size),
        ]
        if self.corrected_identity is not None:
            parts.append(fmt_g(self.corrected_identity))
            parts.append(fmt_g(self.mapq))
        return " ".join(parts)


def parse_mapping_line(line: str) -> MappingLine:
    f = line.split(" ")
    assert len(f) in (12, 14, 15), f"bad mappings line ({len(f)} fields)"
    ml = MappingLine(
        read_id=f[0],
        read_len=int(f[1]),
        strand=1 if f[4] == "+" else -1,
        contig_id=f[5],
        contig_len=int(f[6]),
        ref_start=int(f[7]),
        ref_end=int(f[8]),
        identity=float(f[9]),
        intersection=int(f[10]),
        sketch_size=int(f[11]),
    )
    if len(f) >= 14:
        ml.corrected_identity = float(f[12])
        try:
            ml.mapq = float(f[13])
        except (ValueError, OverflowError):
            ml.mapq = 0.0
    return ml


def iter_reads_grouped(path: str) -> Iterator[List[str]]:
    """Group consecutive mapping lines by read ID (reference
    fEM.h:1237-1274 callBackForAllReads streaming mode)."""
    running_id = None
    lines: List[str] = []
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n").rstrip("\r")
            if not line:
                continue
            rid = line.split(" ", 1)[0]
            if rid != running_id:
                if lines:
                    yield lines
                running_id = rid
                lines = []
            lines.append(line)
    if lines:
        yield lines


# --- sidecars ---------------------------------------------------------------


def write_meta(path_prefix: str, total: int, too_short: int, mapped: int, not_mapped: int):
    with open(path_prefix + ".meta", "w") as f:
        f.write(f"TotalReads {total}\n")
        f.write(f"ReadsTooShort {too_short}\n")
        f.write(f"ReadsMapped {mapped}\n")
        f.write(f"ReadsNotMapped {not_mapped}\n")


def read_meta(path_prefix: str) -> dict:
    out = {}
    with open(path_prefix + ".meta") as f:
        for line in f:
            line = line.strip()
            if line:
                k, v = line.split(" ")
                out[k] = int(v)
    return out


def write_unmapped_lengths(path_prefix: str, entries: Iterable):
    """entries: iterable of (length, read_id)."""
    with open(path_prefix + ".meta.unmappedReadsLengths", "w") as f:
        for length, read_id in entries:
            f.write(f"{length}\t{read_id}\n")


def read_unmapped_lengths(path_prefix: str):
    out = []
    with open(path_prefix + ".meta.unmappedReadsLengths") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                length, read_id = line.split("\t")
                out.append((int(length), read_id))
    return out


def write_parameters_file(path_prefix: str, p) -> None:
    """``<out>.parameters`` sidecar (mapWrap.h:196-211); vectors printed in
    the reference's prettyprint style ``[a, b]``."""

    def vec(v):
        return "[" + ", ".join(v) + "]"

    with open(path_prefix + ".parameters", "w") as f:
        f.write(f"kmerSize {p.kmer_size}\n")
        f.write(f"windowSize {p.window_size}\n")
        f.write(f"minReadLength {p.min_read_length}\n")
        f.write(f"alphabetSize {p.alphabet_size}\n")
        f.write(f"referenceSize {p.reference_size}\n")
        f.write(f"percentageIdentity {fmt_g(p.percentage_identity)}\n")
        f.write(f"p_value {fmt_g(p.p_value)}\n")
        f.write(f"refSequences {vec(p.ref_sequences)}\n")
        f.write(f"querySequences {vec(p.query_sequences)}\n")
        f.write(f"outFileName {p.out_file_name}\n")
        f.write(f"reportAll {1 if p.report_all else 0}\n")
        f.write(f"index {p.index}\n")
        f.write(f"maximumMemory {p.maximum_memory}\n")


def read_parameters_file(path_prefix: str) -> dict:
    out = {}
    with open(path_prefix + ".parameters") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                k, _, v = line.partition(" ")
                out[k] = v
    return out
