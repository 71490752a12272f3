"""Result visualization — plotIdentities_EM.R / plotUnknownResults.R
equivalents (matplotlib).

plot_identities_em: per-genome panels of (a) best-mapping identity
histograms and (b) contig coverage along the genome, from the .EM outputs
(reference plotIdentities_EM.R:1-177).

Counterpart: ``metamaps_tpu/tools/plots.py``, copied so that the port
imports nothing of the JAX package (one docstring names the port's
``evaluate_experiment``). matplotlib is imported inside each function,
never with the module.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional


def plot_identities_em(mappings_prefix: str, out_pdf: Optional[str] = None,
                       min_reads: int = 1):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fn_ident = mappings_prefix + ".EM.lengthAndIdentitiesPerMappingUnit"
    fn_cov = mappings_prefix + ".EM.contigCoverage"
    out_pdf = out_pdf or (mappings_prefix + ".EM.identitiesAndCoverage.pdf")

    idents: Dict[str, List[float]] = {}
    with open(fn_ident) as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            idents.setdefault(fields[1], []).append(float(fields[3]))

    coverage: Dict[str, List[tuple]] = {}
    with open(fn_cov) as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            coverage.setdefault(fields[2], []).append(
                (int(fields[3]), float(fields[6]))
            )

    units = [u for u, v in sorted(idents.items()) if len(v) >= min_reads]
    if not units:
        raise RuntimeError("no mapping units with enough reads to plot")
    fig, axes = plt.subplots(
        len(units), 2, figsize=(11, 2.8 * len(units)), squeeze=False
    )
    for i, unit in enumerate(units):
        ax = axes[i][0]
        ax.hist(np.array(idents[unit]) * 100, bins=np.arange(60, 101), color="#4472a8")
        ax.set_title(f"{unit} — identities ({len(idents[unit])} reads)", fontsize=8)
        ax.set_xlabel("identity %")
        ax2 = axes[i][1]
        cov = coverage.get(unit, [])
        if cov:
            xs = [c[0] for c in cov]
            ys = [c[1] for c in cov]
            ax2.plot(xs, ys, lw=0.5, color="#6aa66e")
        ax2.set_title(f"{unit} — coverage", fontsize=8)
        ax2.set_xlabel("position")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_validation_results(results: Dict, out_pdf: str, title: str = ""):
    """Simulation-accuracy panels (doPlots.R analog): per-category read
    accuracy by level, and per-level composition L1/recall bars, from the
    dict returned by metamaps_tpu_torch.sim.validation.evaluate_experiment."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    reads = results["reads"]
    dist = results["distribution"]
    levels = ["absolute", "strain", "species", "genus", "family", "superkingdom"]
    cats = sorted(reads)

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.2))
    ax = axes[0]
    width = 0.8 / max(1, len(cats))
    xs = np.arange(len(levels))
    for ci, cat in enumerate(cats):
        ys = [reads[cat].get(l, {}).get("accuracy", float("nan")) for l in levels]
        ax.bar(xs + ci * width, ys, width, label=cat)
    ax.set_xticks(xs + 0.4)
    ax.set_xticklabels(levels, rotation=30, fontsize=8)
    ax.set_ylim(0, 1.05)
    ax.set_ylabel("read-level accuracy")
    ax.legend(fontsize=7)
    ax.set_title(f"{title} reads".strip(), fontsize=9)

    ax2 = axes[1]
    dl = [l for l in levels if l in dist]
    ax2.bar(np.arange(len(dl)) - 0.2, [dist[l]["L1"] for l in dl], 0.4,
            label="L1 distance")
    ax2.bar(np.arange(len(dl)) + 0.2, [dist[l]["binary_recall"] for l in dl],
            0.4, label="binary recall")
    ax2.set_xticks(np.arange(len(dl)))
    ax2.set_xticklabels(dl, rotation=30, fontsize=8)
    ax2.legend(fontsize=7)
    ax2.set_title(f"{title} composition".strip(), fontsize=9)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_unknown_results(mappings_prefix: str, out_pdf: Optional[str] = None):
    """Shifted identity histograms per taxon from the U output
    (plotUnknownResults.R equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fn = mappings_prefix + ".U.shiftedHistogramsPerTaxonID"
    out_pdf = out_pdf or (mappings_prefix + ".U.shiftedHistograms.pdf")
    series: Dict[tuple, List[tuple]] = {}
    with open(fn) as f:
        f.readline()
        for line in f:
            taxon, kind, identity, p = line.rstrip("\n").split("\t")
            series.setdefault((taxon, kind), []).append((int(identity), float(p)))
    if not series:
        raise RuntimeError("no histogram rows to plot")
    fig, axes = plt.subplots(len(series), 1, figsize=(8, 2.2 * len(series)),
                             squeeze=False)
    for i, ((taxon, kind), rows) in enumerate(sorted(series.items())):
        rows.sort()
        ax = axes[i][0]
        ax.bar([r[0] for r in rows], [r[1] for r in rows], color="#8a6db1")
        ax.set_title(f"{taxon} ({kind})", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf
