"""One-command evaluation of real-dataset inference results —
util/evaluateExternalDatasets.pl equivalent.

The reference script (evaluateExternalDatasets.pl:1-386) takes, per
dataset, a per-read truth file, the query FASTQ, and one results file pair
(reads2Taxon-style per-read assignments, WIMP-style composition) per
method; it projects the truth into the mapping DB's taxonomy
(validation::translateReadsTruthToReducedTaxonomy), then scores every
method with the same read-level and distribution-level comparison used for
simulations (validation::analyseAndAddOneExperiment). This module is that
driver over the rebuild's existing truth/validation machinery.

Counterpart: ``metamaps_tpu/sim/external_eval.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..taxonomy import Taxonomy
from .validation import (
    EVALUATION_LEVELS,
    distribution_level_comparison,
    parse_wimp,
    read_level_comparison,
    truth_distribution,
)


@dataclass
class MethodFiles:
    """One method's results: either file may be absent (the reference's
    Bracken entry has no per-read file, evaluateExternalDatasets.pl:100)."""
    reads2taxon: Optional[str] = None
    distribution: Optional[str] = None


def _load_reads2taxon(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rid, taxon = line.rstrip("\n").split("\t")[:2]
            out[rid] = taxon
    return out


def read_lengths_from_fastx(path: str) -> Dict[str, int]:
    """Util::getReadLengths analog (first-token read IDs)."""
    from ..io.fasta import read_sequences

    return {name.split()[0]: len(seq) for name, seq in read_sequences(path)}


def evaluate_external(
    db_dir: str,
    truth_file: str,
    methods: Dict[str, MethodFiles],
    fastq: Optional[str] = None,
    out_prefix: Optional[str] = None,
    min_read_length_note: int = 2000,
) -> Dict:
    """Score every method against the truth on one real dataset.

    Returns {"meta": {...}, "methods": {name: {"reads": ...,
    "distribution": ...}}} and, with ``out_prefix``, writes
    ``<out_prefix>.readLevel.tsv`` and ``<out_prefix>.distribution.tsv``
    (the analyseAndAddOneExperiment output tables)."""
    from ..engine.em import load_relevant_taxon_info
    from .truth import project_truth_into_db

    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    mappable = set(load_relevant_taxon_info(db_dir, set()))

    truth_abs = _load_reads2taxon(truth_file)
    # drop reads with unknown truth (reference: truth_reads_href_noUnknown)
    truth_abs = {r: t for r, t in truth_abs.items() if t not in ("", "0")}
    truth_db = project_truth_into_db(truth_abs, taxonomy, mappable)

    meta = {
        "n_truth_reads": len(truth_abs),
        "n_truth_taxa_changed_by_projection": sum(
            1 for r in truth_abs if truth_abs[r] != truth_db[r]
        ),
    }
    if fastq:
        lens = read_lengths_from_fastx(fastq)
        meta["n_reads_below_minlen"] = sum(
            1 for r in truth_abs
            if lens.get(r, min_read_length_note) < min_read_length_note
        )

    truth_dist = truth_distribution(
        taxonomy, {r: truth_db[r] for r in truth_abs}, mappable
    )

    per_method = {}
    for name, files in methods.items():
        entry = {}
        if files.reads2taxon:
            inferred = _load_reads2taxon(files.reads2taxon)
            # restrict to reads with defined truth (reference:
            # keys_with_defined_truth)
            inferred = {r: t for r, t in inferred.items() if r in truth_abs}
            entry["reads"] = read_level_comparison(
                taxonomy, truth_abs, truth_db, inferred, mappable
            )
        if files.distribution:
            inferred_dist = parse_wimp(files.distribution)
            dist = {}
            for level in truth_dist:
                if level in ("absolute", "strain"):
                    inf_level = inferred_dist.get("definedGenomes", {})
                else:
                    inf_level = inferred_dist.get(level, {})
                if inf_level:
                    dist[level] = distribution_level_comparison(
                        truth_dist[level], inf_level
                    )
            entry["distribution"] = dist
        per_method[name] = entry

    result = {"meta": meta, "methods": per_method,
              "truth_distribution": truth_dist}
    if out_prefix:
        write_external_tables(result, out_prefix)
    return result


def write_external_tables(result: Dict, out_prefix: str) -> Tuple[str, str]:
    """The per-method accuracy tables (analyseAndAddOneExperiment /
    produceValidationOutputFiles output shape)."""
    rl_fn = out_prefix + ".readLevel.tsv"
    with open(rl_fn, "w") as f:
        f.write(
            "method\tcategory\tlevel\tN\tcorrect\tmissing\t"
            "N_truthDefined\tcorrect_truthDefined\taccuracy\n"
        )
        for name, entry in sorted(result["methods"].items()):
            for cat, levels in sorted(entry.get("reads", {}).items()):
                for level in ["absolute"] + EVALUATION_LEVELS:
                    if level not in levels:
                        continue
                    b = levels[level]
                    f.write(
                        f"{name}\t{cat}\t{level}\t{b['N']}\t{b['correct']}\t"
                        f"{b['missing']}\t{b['N_truthDefined']}\t"
                        f"{b['correct_truthDefined']}\t{b['accuracy']:.6f}\n"
                    )
    d_fn = out_prefix + ".distribution.tsv"
    with open(d_fn, "w") as f:
        f.write(
            "method\tlevel\tL1\tL2\tr2\tAVGRE\tRRMSE\t"
            "binary_precision\tbinary_recall\n"
        )
        for name, entry in sorted(result["methods"].items()):
            for level, m in sorted(entry.get("distribution", {}).items()):
                f.write(
                    f"{name}\t{level}\t{m['L1']:.6f}\t{m['L2']:.6f}\t"
                    f"{m['r2']:.6f}\t{m['AVGRE']:.6f}\t{m['RRMSE']:.6f}\t"
                    f"{m['binary_precision']:.6f}\t{m['binary_recall']:.6f}\n"
                )
    return rl_fn, d_fn


def parse_method_spec(spec: str) -> Tuple[str, MethodFiles]:
    """CLI method spec: NAME=reads2TaxonPath[:distributionPath]; either
    path may be empty ('NAME=:distPath' gives a distribution-only method
    like the reference's Bracken entry)."""
    name, _, paths = spec.partition("=")
    if not name or not paths:
        raise ValueError(f"bad method spec {spec!r} (want NAME=r2t[:dist])")
    r2t, _, dist = paths.partition(":")
    return name, MethodFiles(
        reads2taxon=r2t or None, distribution=dist or None
    )
