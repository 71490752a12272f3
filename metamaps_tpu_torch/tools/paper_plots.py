"""Publication figure set — paperPlots/paperPlots.R +
util/HMP_and_Zymo_plot_R.R equivalents (matplotlib).

The reference's paper figures (paperPlots.R): per-method read-level
accuracy panels by rank with call-rate circles (HMP_like_reads_plot:516,
:720), two-dataset accuracy comparison (twoReadPlots:425), read-length
histogram (readLengthPlot:331), truth-vs-estimate abundance XY scatters
(xyPlots_i100_p25:938), U-frequency panels (unknownFrequencyPlots:120);
plus HMP_and_Zymo_plot_R.R's per-taxon composition barplots with the L1
column (:139-180) and abundance XY (:198).

All figures consume the rebuild's data structures: the
``evaluate_external`` result dict (read-level + distribution metrics) and
per-level composition dicts ({taxon: freq}) from truth/parse_wimp.

Counterpart: ``metamaps_tpu/tools/paper_plots.py``, copied unchanged so that
the port imports nothing of the JAX package. matplotlib is
imported inside each function, never with the module.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

# paperPlots.R:33-47 colourByMethod
METHOD_COLORS = {
    "MetaMaps": "tab:blue",
    "MetaMaps-EM": "tab:blue",
    "MetaMaps-U": "gold",
    "Kraken": "firebrick",
    "Kraken2": "firebrick",
    "Bracken": "firebrick",
    "Centrifuge": "orange",
    "MEGAN": "lightpink",
    "MEGAN-LR": "lightpink",
}
RANK_ORDER = ["absolute", "species", "genus", "family", "order", "phylum",
              "superkingdom"]


def _color(method: str):
    for key, c in METHOD_COLORS.items():
        if method.lower().startswith(key.lower()):
            return c
    return None  # matplotlib cycles


def _ranks_in(levels) -> List[str]:
    return [r for r in RANK_ORDER if r in levels]


def plot_read_length_hist(lengths_by_dataset: Dict[str, Sequence[int]],
                          out_pdf: str, bins: int = 60):
    """readLengthPlot (paperPlots.R:331-423): read-length distributions,
    log-x histogram per dataset."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    for name, lens in lengths_by_dataset.items():
        lens = np.asarray(list(lens), float)
        lens = lens[lens > 0]
        if not len(lens):
            continue
        lo, hi = max(1, lens.min()), lens.max()
        if hi <= lo:  # degenerate single-length dataset
            lo, hi = lo * 0.9, lo * 1.1 + 1
        edges = np.geomspace(lo, hi, bins)
        ax.hist(lens, bins=edges, histtype="step", lw=1.8, label=name,
                density=True)
    ax.set_xscale("log")
    ax.set_xlabel("Read length (bp)")
    ax.set_ylabel("Density")
    ax.set_title("Read length distributions")
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_reads_panel(methods_reads: Dict[str, Dict],
                     out_pdf: str, title: str = "",
                     category: Optional[str] = None):
    """HMP_like_reads_plot (paperPlots.R:516-718): grouped per-rank bars of
    per-read accuracy per method, with call-rate markers above each group.

    ``methods_reads``: {method: read_level_comparison result}. With
    ``category`` None, categories are summed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def agg(rl):
        # sum category buckets -> {level: (N, correct, missing)}
        out = {}
        for cat, levels in rl.items():
            if category is not None and cat != category:
                continue
            for level, b in levels.items():
                n, c, m = out.get(level, (0, 0, 0))
                out[level] = (n + b["N"], c + b["correct"],
                              m + b["missing"])
        return out

    per_method = {name: agg(rl) for name, rl in methods_reads.items()}
    ranks = _ranks_in(
        set().union(*[set(v) for v in per_method.values()] or [set()])
    )
    methods = list(per_method)
    W = 0.8 / max(1, len(methods))

    fig, ax = plt.subplots(figsize=(8, 6))
    for mi, m in enumerate(methods):
        xs, acc, call = [], [], []
        for ri, r in enumerate(ranks):
            n, c, miss = per_method[m].get(r, (0, 0, 0))
            xs.append(ri + mi * W)
            acc.append(c / n if n else float("nan"))
            call.append(n / (n + miss) if (n + miss) else float("nan"))
        bars = ax.bar(xs, acc, width=W, label=m, color=_color(m),
                      edgecolor="black", linewidth=0.4)
        # call-rate circles above the bars (plotCircles, paperPlots.R:661)
        for x, cr in zip(xs, call):
            if not math.isnan(cr):
                ax.plot([x], [1.04], marker="o", ms=9,
                        mfc=bars[0].get_facecolor(), mec="black",
                        alpha=max(0.15, cr), clip_on=False)
    ax.set_xticks([i + 0.4 - W / 2 for i in range(len(ranks))])
    ax.set_xticklabels([r.capitalize() for r in ranks])
    ax.set_ylim(0, 1.05)
    ax.set_ylabel("Per-read accuracy")
    ax.set_title(title or "Read assignment accuracy by rank "
                          "(circles: call rate)")
    ax.legend(frameon=False, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_two_dataset_accuracy(results_by_dataset: Dict[str, Dict[str, Dict]],
                              out_pdf: str):
    """twoReadPlots / readAccuracyPlot (paperPlots.R:425-514): per-method
    accuracy-vs-rank lines, one panel per dataset."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(results_by_dataset)
    fig, axes = plt.subplots(1, max(1, n), figsize=(4.5 * max(1, n), 5),
                             squeeze=False)
    for ax, (ds, methods_reads) in zip(axes[0], results_by_dataset.items()):
        for m, rl in methods_reads.items():
            agg = {}
            for cat, levels in rl.items():
                for level, b in levels.items():
                    nn, cc = agg.get(level, (0, 0))
                    agg[level] = (nn + b["N"], cc + b["correct"])
            ranks = _ranks_in(agg)
            ys = [agg[r][1] / agg[r][0] if agg[r][0] else float("nan")
                  for r in ranks]
            ax.plot(range(len(ranks)), ys, marker="o", label=m,
                    color=_color(m))
        ax.set_xticks(range(len(ranks)))
        ax.set_xticklabels([r.capitalize() for r in ranks], rotation=30)
        ax.set_ylim(0, 1.02)
        ax.set_title(ds)
        ax.set_ylabel("Per-read accuracy")
    axes[0][0].legend(frameon=False, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_abundance_xy(truth_dist: Dict[str, float],
                      methods_dist: Dict[str, Dict[str, float]],
                      out_pdf: str, level: str = "species"):
    """Truth-vs-estimate abundance scatter per method
    (xyPlots_i100_p25, paperPlots.R:938-1214; HMP_and_Zymo_plot_R.R:198)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(methods_dist)
    cols = min(3, max(1, n))
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4.2 * cols, 4.2 * rows),
                             squeeze=False)
    taxa = sorted(set(truth_dist) - {"Unclassified", "Undefined"})
    lim = 1.05 * max(
        [truth_dist.get(t, 0.0) for t in taxa]
        + [d.get(t, 0.0) for d in methods_dist.values() for t in taxa]
        + [0.01]
    )
    for i, (m, dist) in enumerate(methods_dist.items()):
        ax = axes[i // cols][i % cols]
        xs = [truth_dist.get(t, 0.0) for t in taxa]
        ys = [dist.get(t, 0.0) for t in taxa]
        ax.plot([0, lim], [0, lim], color="gray", lw=0.8, ls="--")
        ax.scatter(xs, ys, s=28, color=_color(m), edgecolor="black",
                   linewidth=0.4)
        ax.set_xlim(0, lim)
        ax.set_ylim(0, lim)
        ax.set_title(f"{m} [{level}]")
        ax.set_xlabel("Truth")
        ax.set_ylabel("Estimate")
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_composition_bars(truth_dist: Dict[str, float],
                          methods_dist: Dict[str, Dict[str, float]],
                          out_pdf: str, level: str = "species",
                          top_n: int = 15):
    """Per-taxon grouped composition bars (truth + each method) with an L1
    summary column (HMP_and_Zymo_plot_R.R:139-180)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    taxa = sorted(
        (t for t in truth_dist if t not in ("Unclassified", "Undefined")),
        key=lambda t: -truth_dist[t],
    )[:top_n]
    series = {"Truth": truth_dist, **methods_dist}
    W = 0.8 / len(series)
    fig, ax = plt.subplots(figsize=(max(8, 0.7 * len(taxa) + 3), 5))
    for si, (name, dist) in enumerate(series.items()):
        xs = [i + si * W for i in range(len(taxa))]
        ys = [dist.get(t, 0.0) for t in taxa]
        color = "gray" if name == "Truth" else _color(name)
        ax.bar(xs, ys, width=W, label=name, color=color,
               edgecolor="black", linewidth=0.3)
    # L1 column per method
    x0 = len(taxa) + 0.5
    for si, (name, dist) in enumerate(series.items()):
        if name == "Truth":
            continue
        joint = set(truth_dist) | set(dist)
        l1 = sum(abs(dist.get(t, 0.0) - truth_dist.get(t, 0.0))
                 for t in joint)
        color = _color(name)
        ax.bar([x0 + si * W], [l1], width=W, color=color,
               edgecolor="black", linewidth=0.3, hatch="//")
    ax.set_xticks(
        [i + 0.4 - W / 2 for i in range(len(taxa))] + [x0 + 0.4 - W / 2]
    )
    ax.set_xticklabels(list(taxa) + ["L1"], rotation=60, ha="right",
                       fontsize=8)
    ax.set_ylabel("Frequency")
    ax.set_title(f"Composition at {level} (hatched: L1 distance)")
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def plot_unknown_frequency(methods_dist: Dict[str, Dict[str, float]],
                           truth_unclassified: float, out_pdf: str):
    """unknownFrequencyPlots (paperPlots.R:120-329): per-method estimated
    unclassified/novel fraction vs truth."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    methods = list(methods_dist)
    vals = [methods_dist[m].get("Unclassified", 0.0) for m in methods]
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.bar(range(len(methods)), vals,
           color=[_color(m) for m in methods], edgecolor="black",
           linewidth=0.4)
    ax.axhline(truth_unclassified, color="gray", ls="--",
               label=f"truth ({truth_unclassified:.2f})")
    ax.set_xticks(range(len(methods)))
    ax.set_xticklabels(methods, rotation=30, ha="right")
    ax.set_ylabel("Estimated unclassified fraction")
    ax.set_title("Unknown-fraction estimates")
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def paper_plot_suite(eval_result: Dict, truth_dist_by_level: Dict,
                     methods_dist_by_level: Dict[str, Dict],
                     out_prefix: str,
                     read_lengths: Optional[Dict[str, Sequence[int]]] = None,
                     level: str = "species") -> List[str]:
    """Produce the full figure set from one ``evaluate_external`` run.

    ``methods_dist_by_level``: {method: {level: {taxon: freq}}} (e.g. from
    parse_wimp per method)."""
    outs = []
    methods_reads = {
        m: e["reads"] for m, e in eval_result["methods"].items()
        if "reads" in e
    }
    if methods_reads:
        outs.append(plot_reads_panel(
            methods_reads, out_prefix + ".readsPanel.pdf"))
        outs.append(plot_two_dataset_accuracy(
            {"dataset": methods_reads}, out_prefix + ".readAccuracy.pdf"))
    level_dists = {
        m: d.get(level, {}) for m, d in methods_dist_by_level.items()
        if d.get(level)
    }
    truth_level = truth_dist_by_level.get(level, {})
    if level_dists and truth_level:
        outs.append(plot_abundance_xy(
            truth_level, level_dists, out_prefix + ".abundanceXY.pdf",
            level=level))
        outs.append(plot_composition_bars(
            truth_level, level_dists, out_prefix + ".composition.pdf",
            level=level))
        outs.append(plot_unknown_frequency(
            level_dists, truth_level.get("Undefined", 0.0),
            out_prefix + ".unknownFrequency.pdf"))
    if read_lengths:
        outs.append(plot_read_length_hist(
            read_lengths, out_prefix + ".readLengths.pdf"))
    return outs
