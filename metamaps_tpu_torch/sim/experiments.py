"""Experiment orchestration & result store — the analyzeAll layer.

The reference drives accuracy experiments with simulate.pl (actions
prepare/inferenceJobI/analyzeAll, simulate.pl:247-960) + validation.pm
(analyseAndAddOneExperiment :1063, produceValidationOutputFiles :1869) and
plots them with doPlots.R. This module is that harness for the rebuild:

one call runs the full matrix

    simulated reads  x  DB variants (full + leave-out holdouts)  x  tools
    (metamaps_tpu_torch, kraken2, centrifuge — competitors auto-skip when not
    installed)

with a resumable on-disk store (flag files, like simulate.pl:2311-2352),
then aggregates per-rank read-level accuracy and composition distances
into TSV tables and a doPlots-style comparison figure.

Store layout:

    <store>/<name>/reads.fastq, reads.truth
    <store>/<name>/dbs/<variant>/           (reduced DBs; 'full' = source)
    <store>/<name>/runs/<variant>__<tool>/  (tool outputs + metrics.json)
    <store>/<name>/tables/*.tsv, plots/comparison.pdf, results.json

Counterpart: ``metamaps_tpu/sim/experiments.py``, copied so that the port
imports nothing of the JAX package, with these changes: the metamaps runs
take the port's engine kinds (``torch``, the default, or ``oracle``) and a
device for the mapping engine and the EM rounds (``cuda`` unless ``cpu`` is
asked for; without CUDA the run raises before it starts); a run is recorded
as skipped only when a competitor's binary is not installed
(:class:`CompetitorNotInstalled`), and any other failure of a run
propagates, with no done-flag for it; the plots are skipped only when
matplotlib cannot be imported. ``run_experiment(..., run_stats=...)`` also
reports where the time went.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..device import require_cuda
from ..taxonomy import Taxonomy
from ..tools.competitors import CompetitorNotInstalled
from .simulate import produce_reduced_db, run_inference, simulate_reads, write_simulation
from .validation import (
    distribution_level_comparison,
    evaluate_experiment,
    parse_wimp,
    read_level_comparison,
    truth_distribution,
)

LEVELS = ["absolute", "species", "genus", "family"]


@dataclass
class ExperimentSpec:
    name: str
    db_dir: str
    n_reads: int = 300
    seed: int = 0
    mean_length: int = 5000
    accuracy: float = 0.88
    min_read_len: int = 2000
    # variant name -> taxa to remove (empty list = the full DB)
    variants: Dict[str, List[str]] = field(default_factory=lambda: {"full": []})
    tools: List[str] = field(default_factory=lambda: ["metamaps"])
    engine: str = "torch"
    device: str = "cuda"


def _flag(path: str) -> bool:
    return os.path.exists(path + ".ok")


def _set_flag(path: str):
    open(path + ".ok", "w").write("1\n")


def pick_holdout_taxa(db_dir: str, n: int, seed: int = 0) -> List[str]:
    """n random directly-mappable taxa for a leave-out variant."""
    from ..engine.em import load_relevant_taxon_info

    taxa = sorted(load_relevant_taxon_info(db_dir, set()))
    rng = np.random.default_rng(seed)
    return [taxa[i] for i in rng.choice(len(taxa), size=n, replace=False)]


def _run_metamaps(db_dir, fastq, out_prefix, spec, stats=None):
    run_inference(db_dir, fastq, out_prefix, min_read_len=spec.min_read_len,
                  engine=spec.engine, device=spec.device, stats=stats)
    return out_prefix + ".EM.reads2Taxon"


def _run_kraken2(db_dir, fastq, out_prefix, spec, stats=None):
    from ..tools.competitors import kraken_reads_to_reads2taxon, run_kraken

    run_kraken(db_dir, fastq, out_prefix)
    r2t = out_prefix + ".reads2Taxon"
    kraken_reads_to_reads2taxon(out_prefix + ".reads", r2t)
    return r2t


def _run_centrifuge(db_dir, fastq, out_prefix, spec, stats=None):
    from ..tools.competitors import (
        centrifuge_reads_to_reads2taxon,
        run_centrifuge,
    )

    run_centrifuge(os.path.join(db_dir, "centrifuge_index"), fastq, out_prefix)
    r2t = out_prefix + ".reads2Taxon"
    centrifuge_reads_to_reads2taxon(out_prefix + ".reads", r2t)
    return r2t


_TOOL_RUNNERS = {
    "metamaps": _run_metamaps,
    "kraken2": _run_kraken2,
    "centrifuge": _run_centrifuge,
}


def _evaluate_r2t(db_dir: str, full_db_dir: str, truth_file: str,
                  r2t_file: str, wimp_file: Optional[str]) -> Dict:
    """Metrics for one run: read-level accuracy by category/level, plus
    composition distances (from .EM.WIMP when present, else from assigned
    read counts — how the reference scores Kraken-class outputs).

    Evaluation uses the FULL DB's taxonomy (truth taxa held out of a
    reduced variant still exist there — validation.pm keeps the complete
    tree) with the VARIANT's mappable set; absolute truth is projected to
    its closest mappable attachment node (readLevelComparison's
    truth-in-DB, validation.pm:433)."""
    from ..engine.em import load_relevant_taxon_info
    from .truth import project_truth_into_db

    taxonomy = Taxonomy(os.path.join(full_db_dir, "taxonomy"))
    mappable = set(load_relevant_taxon_info(db_dir, set()))

    truth_abs = dict(
        line.rstrip("\n").split("\t")
        for line in open(truth_file) if line.strip()
    )
    inferred = dict(
        line.rstrip("\n").split("\t")
        for line in open(r2t_file) if line.strip()
    )
    truth_db = project_truth_into_db(truth_abs, taxonomy, mappable)
    reads = read_level_comparison(taxonomy, truth_abs, truth_db, inferred,
                                  mappable)

    truth_dist = truth_distribution(taxonomy, truth_db, mappable)
    if wimp_file and os.path.exists(wimp_file):
        inferred_dist = parse_wimp(wimp_file)
    else:
        inferred_dist = _distribution_from_r2t(taxonomy, inferred, mappable)
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
    return {"reads": reads, "distribution": dist}


def _distribution_from_r2t(taxonomy, inferred: Dict[str, str], mappable):
    """Per-level composition from assigned read counts (the reference's
    treatment of competitor outputs, SimulationsKraken.pm converters)."""
    from .validation import lightning

    out: Dict[str, Dict[str, float]] = {}
    n = max(1, len(inferred))
    for rid, t in inferred.items():
        if t == "0" or not taxonomy.know_node(t):
            levels = {lv: "Unclassified" for lv in LEVELS}
            levels["definedGenomes"] = "Unclassified"
        else:
            levels = lightning(taxonomy, t, mappable)
            levels["definedGenomes"] = t
        for lv, node in levels.items():
            out.setdefault(lv, {}).setdefault(node, 0.0)
            out[lv][node] += 1.0 / n
    return out


def run_experiment(spec: ExperimentSpec, store_root: str,
                   run_stats: Optional[Dict] = None) -> Dict:
    """Run the full matrix; resumable — finished steps are flag-skipped.
    ``run_stats``, when given, gets the wall seconds of each step that ran
    (``simulate_s``, ``reduced_db_s`` per variant) and, per metamaps run
    under ``runs``, its ``mapDirectly_s``, ``classify_s``, ``evaluate_s``
    and the mapping engine's counters (``map_s``, ``oracle_fallbacks``,
    ...)."""
    if "metamaps" in spec.tools:
        require_cuda(spec.device)
    if run_stats is None:
        run_stats = {}
    root = os.path.join(store_root, spec.name)
    os.makedirs(root, exist_ok=True)

    # 1. simulate reads once from the FULL DB
    reads_prefix = os.path.join(root, "reads")
    if not _flag(reads_prefix):
        t0 = time.perf_counter()
        rng = np.random.default_rng(spec.seed)
        reads = simulate_reads(
            spec.db_dir, spec.n_reads, rng, mean_length=spec.mean_length,
            min_length=spec.min_read_len, accuracy=spec.accuracy,
        )
        write_simulation(reads, reads_prefix)
        _set_flag(reads_prefix)
        run_stats["simulate_s"] = time.perf_counter() - t0

    # 2. DB variants
    dbs = {}
    for variant, remove in spec.variants.items():
        if not remove:
            dbs[variant] = spec.db_dir
            continue
        vdir = os.path.join(root, "dbs", variant)
        if not _flag(vdir):
            t0 = time.perf_counter()
            produce_reduced_db(spec.db_dir, vdir, remove)
            _set_flag(vdir)
            run_stats.setdefault("reduced_db_s", {})[variant] = (
                time.perf_counter() - t0)
        dbs[variant] = vdir

    # 3. runs + metrics
    results: Dict[str, Dict] = {}
    for variant, db in dbs.items():
        for tool in spec.tools:
            key = f"{variant}__{tool}"
            rdir = os.path.join(root, "runs", key)
            os.makedirs(rdir, exist_ok=True)
            prefix = os.path.join(rdir, "out")
            metrics_fn = os.path.join(rdir, "metrics.json")
            if not _flag(rdir):
                stats = run_stats.setdefault("runs", {}).setdefault(key, {})
                try:
                    r2t = _TOOL_RUNNERS[tool](db, reads_prefix + ".fastq",
                                              prefix, spec, stats)
                except CompetitorNotInstalled as e:  # only competitors raise it
                    json.dump({"skipped": str(e)}, open(metrics_fn, "w"))
                    _set_flag(rdir)
                    results[key] = {"skipped": str(e)}
                    continue
                t0 = time.perf_counter()
                wimp = prefix + ".EM.WIMP" if tool == "metamaps" else None
                m = _evaluate_r2t(db, spec.db_dir, reads_prefix + ".truth",
                                  r2t, wimp)
                json.dump(m, open(metrics_fn, "w"), default=float)
                _set_flag(rdir)
                stats["evaluate_s"] = time.perf_counter() - t0
            results[key] = json.load(open(metrics_fn))

    json.dump(results, open(os.path.join(root, "results.json"), "w"),
              default=float)
    write_tables(results, os.path.join(root, "tables"))
    try:
        plot_comparison(results, os.path.join(root, "plots", "comparison.pdf"),
                        title=spec.name)
    except ImportError:
        pass  # matplotlib optional; the tables and results.json stand alone
    return results


def write_tables(results: Dict, out_dir: str):
    """Aggregate TSVs (produceValidationOutputFiles analog,
    validation.pm:1869): per-run per-level read accuracy by category, and
    composition distances."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "reads_accuracy.tsv"), "w") as f:
        f.write("run\tcategory\tlevel\tnReads\tcorrect\taccuracy\n")
        for key in sorted(results):
            r = results[key]
            if "skipped" in r:
                continue
            for cat, by_level in sorted(r["reads"].items()):
                for level, m in sorted(by_level.items()):
                    n, ok = m["N"], m["correct"]
                    f.write(f"{key}\t{cat}\t{level}\t{n}\t{ok}\t"
                            f"{ok / n if n else 0:.4f}\n")
    with open(os.path.join(out_dir, "composition.tsv"), "w") as f:
        f.write("run\tlevel\tL1\tL2\tr2\tAVGRE\tRRMSE\t"
                "binaryPrecision\tbinaryRecall\n")
        for key in sorted(results):
            r = results[key]
            if "skipped" in r:
                continue
            for level, m in sorted(r["distribution"].items()):
                f.write(
                    f"{key}\t{level}\t{m['L1']:.4f}\t{m['L2']:.4f}\t"
                    f"{m.get('r2', float('nan')):.4f}\t{m['AVGRE']:.4f}\t"
                    f"{m['RRMSE']:.4f}\t{m.get('binary_precision', 0):.4f}\t"
                    f"{m.get('binary_recall', 0):.4f}\n"
                )


def plot_comparison(results: Dict, out_pdf: str, title: str = ""):
    """doPlots.R-style panels: read accuracy by level (grouped by run),
    composition L1 by level, and species accuracy stratified by read
    category (the truthLeafInDB/novel/... breakdown of
    validation.pm:433 readLevelComparison that doPlots.R facets on)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(out_pdf), exist_ok=True)
    runs = [k for k in sorted(results) if "skipped" not in results[k]]
    if not runs:
        return
    fig, axes = plt.subplots(1, 3, figsize=(17, 4.5))

    levels = [l for l in LEVELS if l != "absolute"]
    width = 0.8 / max(1, len(runs))
    x = np.arange(len(levels))
    for i, key in enumerate(runs):
        allc = results[key]["reads"].get("ALL", {})
        acc = [
            (allc.get(lv, {}).get("correct", 0) / allc[lv]["N"])
            if allc.get(lv, {}).get("N") else np.nan
            for lv in levels
        ]
        axes[0].bar(x + i * width, acc, width, label=key)
    axes[0].set_xticks(x + 0.4 - width / 2)
    axes[0].set_xticklabels(levels)
    axes[0].set_ylabel("read-level accuracy (ALL)")
    axes[0].set_ylim(0, 1.05)
    axes[0].legend(fontsize=7)

    for i, key in enumerate(runs):
        dist = results[key]["distribution"]
        l1 = [dist.get(lv, {}).get("L1", np.nan) for lv in levels]
        axes[1].bar(x + i * width, l1, width, label=key)
    axes[1].set_xticks(x + 0.4 - width / 2)
    axes[1].set_xticklabels(levels)
    axes[1].set_ylabel("composition L1 distance")

    cats = sorted({
        c for key in runs for c in results[key]["reads"] if c != "ALL"
    })
    xc = np.arange(len(cats))
    for i, key in enumerate(runs):
        by_cat = results[key]["reads"]
        acc = [
            (by_cat.get(c, {}).get("species", {}).get("correct", 0)
             / by_cat[c]["species"]["N"])
            if by_cat.get(c, {}).get("species", {}).get("N") else np.nan
            for c in cats
        ]
        axes[2].bar(xc + i * width, acc, width, label=key)
    axes[2].set_xticks(xc + 0.4 - width / 2)
    axes[2].set_xticklabels(cats, rotation=30, ha="right", fontsize=7)
    axes[2].set_ylabel("species accuracy by read category")
    axes[2].set_ylim(0, 1.05)

    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def aggregate_store(store_root: str, out_dir: Optional[str] = None) -> Dict:
    """Cross-experiment aggregation (validation.pm
    analyseAndAddOneExperiment :1063 + produceValidationOutputFiles :1869):
    collects every <store>/<experiment>/results.json, emits combined
    per-(experiment, run) tables and a summary matrix of ALL-category
    species accuracy and species-level composition L1."""
    out_dir = out_dir or os.path.join(store_root, "_aggregate")
    os.makedirs(out_dir, exist_ok=True)
    combined: Dict[str, Dict] = {}
    for name in sorted(os.listdir(store_root)):
        fn = os.path.join(store_root, name, "results.json")
        if not os.path.isfile(fn):
            continue
        res = json.load(open(fn))
        for run, m in res.items():
            combined[f"{name}/{run}"] = m
    write_tables(combined, out_dir)

    with open(os.path.join(out_dir, "summary.tsv"), "w") as f:
        f.write("experiment\trun\tspeciesAccuracy_ALL\tspeciesL1\t"
                "novelAccuracy_genus\n")
        for key in sorted(combined):
            m = combined[key]
            exp, _, run = key.partition("/")
            if "skipped" in m:
                f.write(f"{exp}\t{run}\tskipped\tskipped\tskipped\n")
                continue
            sp = m["reads"].get("ALL", {}).get("species", {})
            acc = sp["correct"] / sp["N"] if sp.get("N") else float("nan")
            l1 = m["distribution"].get("species", {}).get("L1", float("nan"))
            novel = float("nan")
            for cat, lv in m["reads"].items():
                if cat == "novel" and lv.get("genus", {}).get("N"):
                    novel = lv["genus"]["correct"] / lv["genus"]["N"]
            f.write(f"{exp}\t{run}\t{acc:.4f}\t{l1:.4f}\t{novel:.4f}\n")
    try:
        plot_comparison(combined, os.path.join(out_dir, "comparison.pdf"),
                        title="all experiments")
    except ImportError:
        pass  # matplotlib optional
    return combined
