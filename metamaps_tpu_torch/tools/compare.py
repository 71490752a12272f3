"""Mapping comparison and single-run benchmarking —
util/compareMappings.pl and benchmarkInference.pl equivalents.

Counterpart: ``metamaps_tpu/tools/compare.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..io.mappings import iter_reads_grouped, parse_mapping_line


def compare_mappings(file_a: str, file_b: str, pos_tolerance: int = 0):
    """Per-read diff of two mappings files: identical lines, position
    deltas, reads present in only one file."""
    def load(path):
        out = {}
        for lines in iter_reads_grouped(path):
            rid = lines[0].split(" ", 1)[0]
            out[rid] = lines
        return out

    a, b = load(file_a), load(file_b)
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    identical = 0
    different = []
    for rid in sorted(set(a) & set(b)):
        if a[rid] == b[rid]:
            identical += 1
            continue
        la = [parse_mapping_line(l) for l in a[rid]]
        lb = [parse_mapping_line(l) for l in b[rid]]
        same = len(la) == len(lb) and all(
            x.contig_id == y.contig_id
            and abs(x.ref_start - y.ref_start) <= pos_tolerance
            and x.intersection == y.intersection
            for x, y in zip(la, lb)
        )
        if same:
            identical += 1
        else:
            different.append(rid)
    return {
        "n_a": len(a),
        "n_b": len(b),
        "identical": identical,
        "different": different,
        "only_a": only_a,
        "only_b": only_b,
    }


def benchmark_inference(mappings_prefix: str, truth_file: str):
    """Per-read accuracy of a reads2Taxon output against a truth table
    (benchmarkInference.pl equivalent)."""
    truth: Dict[str, str] = {}
    with open(truth_file) as f:
        for line in f:
            rid, taxon = line.rstrip("\n").split("\t")
            truth[rid] = taxon
    n = correct = unclassified = missing = 0
    with open(mappings_prefix + ".EM.reads2Taxon") as f:
        inferred = dict(
            line.rstrip("\n").split("\t") for line in f if line.strip()
        )
    for rid, t in truth.items():
        n += 1
        got = inferred.get(rid)
        if got is None:
            missing += 1
        elif got == "0":
            unclassified += 1
        elif got == t:
            correct += 1
    return {
        "n": n,
        "correct": correct,
        "unclassified": unclassified,
        "missing": missing,
        "accuracy": correct / n if n else float("nan"),
    }
