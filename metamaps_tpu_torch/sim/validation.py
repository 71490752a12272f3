"""Accuracy metrics — perlLib/validation.pm equivalents.

- :func:`read_level_comparison` (validation.pm:433 readLevelComparison):
  per-read assignment accuracy at levels absolute/strain/species/genus/
  family/superkingdom, stratified by read category (ALL, truthLeafInDB,
  novel, novel_to_<rank>, truthUnclassified), using the "lightning"
  per-rank projection of a taxon (ranks below the node are Unclassified);
- :func:`distribution_level_comparison` (validation.pm:1473):
  composition accuracy per level — L1, L2, r^2, AVGRE, RRMSE and
  binary precision/recall over detected taxa.

Counterpart: ``metamaps_tpu/sim/validation.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..taxonomy import Taxonomy

EVALUATION_LEVELS = ["strain", "species", "genus", "family", "superkingdom"]
_RANK_ORDER = ["strain", "species", "genus", "family", "order", "phylum", "superkingdom"]


def lightning(taxonomy: Taxonomy, taxon_id: str, mappable: Set[str]) -> Dict[str, str]:
    """Per-level projection of a taxon: levels at or above its position get
    the upward node (or 'Undefined' when the path lacks the rank), levels
    below it get 'Unclassified'. taxon '0' is Unclassified everywhere."""
    out = {l: "Unclassified" for l in EVALUATION_LEVELS}
    out["absolute"] = taxon_id if taxon_id != "0" else "Unclassified"
    if taxon_id == "0":
        return out
    out["strain"] = taxon_id if taxon_id in mappable else "Unclassified"
    upward = taxonomy.get_upward_nodes(taxon_id)
    ranks_on_path = {taxonomy.get_node(n).rank: n for n in upward}
    node_rank = taxonomy.get_node(taxon_id).rank
    # position of the node's own rank in the canonical order ('no rank' and
    # pseudospecies sit below species)
    node_pos = _RANK_ORDER.index(node_rank) if node_rank in _RANK_ORDER else -1
    for level in EVALUATION_LEVELS[1:]:
        lv_pos = _RANK_ORDER.index(level)
        if level in ranks_on_path:
            out[level] = ranks_on_path[level]
        elif lv_pos < node_pos:
            out[level] = "Unclassified"
        elif lv_pos > node_pos:
            out[level] = "Undefined"
    return out


def read_categories(
    taxonomy: Taxonomy,
    truth_absolute: str,
    truth_mapping_db: str,
    mappable: Set[str],
) -> List[str]:
    """(validation.pm:481-616): ALL + truthLeafInDB / truthUnclassified /
    novel + novel_to_<first defined rank of the in-DB truth>."""
    cats = ["ALL"]
    if truth_mapping_db == truth_absolute:
        cats.append("truthLeafInDB" if truth_absolute != "0" else "truthUnclassified")
    else:
        cats.append("novel")
        lt = lightning(taxonomy, truth_mapping_db, mappable)
        for rank in EVALUATION_LEVELS:
            if lt[rank] not in ("Unclassified", "Undefined"):
                cats.append(f"novel_to_{rank}")
                break
    return cats


def read_level_comparison(
    taxonomy: Taxonomy,
    truth_absolute: Dict[str, str],
    truth_mapping_db: Dict[str, str],
    inferred: Dict[str, str],
    mappable: Set[str],
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Returns {category: {level: {N, correct, missing, N_truthDefined,
    correct_truthDefined, accuracy}}}."""
    out: Dict[str, Dict[str, Dict[str, float]]] = {}

    def bucket(cat, level):
        return out.setdefault(cat, {}).setdefault(
            level,
            {"N": 0, "correct": 0, "missing": 0, "N_truthDefined": 0,
             "correct_truthDefined": 0},
        )

    for read_id, truth_abs in truth_absolute.items():
        truth_db = truth_mapping_db.get(read_id, truth_abs)
        cats = read_categories(taxonomy, truth_abs, truth_db, mappable)
        lt_truth = lightning(taxonomy, truth_db, mappable)
        if read_id not in inferred:
            for cat in cats:
                for level in ["absolute"] + EVALUATION_LEVELS:
                    bucket(cat, level)["missing"] += 1
            continue
        lt_inf = lightning(taxonomy, inferred[read_id], mappable)
        for cat in cats:
            for level in ["absolute"] + EVALUATION_LEVELS:
                b = bucket(cat, level)
                t = lt_truth[level]
                i = lt_inf[level]
                b["N"] += 1
                if t == i:
                    b["correct"] += 1
                if t not in ("Unclassified", "Undefined"):
                    b["N_truthDefined"] += 1
                    if t == i:
                        b["correct_truthDefined"] += 1

    for cat in out:
        for level in out[cat]:
            b = out[cat][level]
            b["accuracy"] = b["correct"] / b["N"] if b["N"] else float("nan")
    return out


def truth_distribution(
    taxonomy: Taxonomy, truth_per_read: Dict[str, str], mappable: Set[str]
) -> Dict[str, Dict[str, float]]:
    """Per-level truth composition from per-read truth."""
    out: Dict[str, Dict[str, float]] = {}
    n = len(truth_per_read)
    for taxon in truth_per_read.values():
        lt = lightning(taxonomy, taxon, mappable)
        for level in ["absolute"] + EVALUATION_LEVELS:
            d = out.setdefault(level, {})
            d[lt[level]] = d.get(lt[level], 0.0) + 1.0 / n
    return out


def parse_wimp(path: str) -> Dict[str, Dict[str, float]]:
    """Inferred composition per level from a .EM.WIMP file (PotFrequency);
    taxon 0 becomes 'Unclassified', bookkeeping rows dropped."""
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            level, taxon, _, _, _, pot = fields
            if taxon == "-3":
                continue
            key = "Unclassified" if taxon == "0" else taxon
            out.setdefault(level, {})[key] = float(pot)
    if "definedGenomes" in out:
        out.setdefault("absolute", out["definedGenomes"])
        out.setdefault("strain", out["definedGenomes"])
    return out


def distribution_level_comparison(
    truth: Dict[str, float], inferred: Dict[str, float]
) -> Dict[str, float]:
    """L1/L2/r2/AVGRE/RRMSE + binary precision/recall for one level
    (validation.pm:1595-1700)."""
    avgre = rrmse = 0.0
    for taxon, should in truth.items():
        if taxon == "Unclassified" or should <= 0:
            continue
        got = inferred.get(taxon, 0.0)
        avgre += abs(should - got) / should
        rrmse += ((should - got) / should) ** 2

    joint = set(truth) | set(inferred)
    l1 = l2 = 0.0
    should_pos, is_pos = [], []
    for taxon in joint:
        got = inferred.get(taxon, 0.0)
        should = truth.get(taxon, 0.0)
        l1 += abs(got - should)
        l2 += (got - should) ** 2
        if got > 0 or should > 0:
            should_pos.append(should)
            is_pos.append(got)

    r2 = float("nan")
    if len(should_pos) > 1 and np.std(should_pos) > 0 and np.std(is_pos) > 0:
        r = float(np.corrcoef(should_pos, is_pos)[0, 1])
        r2 = r * r

    n_is = sum(1 for x in is_pos if x > 0)
    n_is_ok = sum(1 for s, x in zip(should_pos, is_pos) if x > 0 and s > 0)
    n_should = sum(1 for s in should_pos if s > 0)
    n_should_ok = sum(1 for s, x in zip(should_pos, is_pos) if s > 0 and x > 0)

    return {
        "L1": l1,
        "L2": math.sqrt(l2),
        "r2": r2,
        "AVGRE": avgre,
        "RRMSE": math.sqrt(rrmse) if rrmse else 0.0,
        "binary_precision": n_is_ok / n_is if n_is else float("nan"),
        "binary_recall": n_should_ok / n_should if n_should else float("nan"),
    }


def evaluate_experiment(
    db_dir: str,
    truth_file: str,
    mappings_prefix: str,
    truth_mapping_db: Optional[Dict[str, str]] = None,
):
    """Full evaluation of one inference run: per-read accuracy by category
    and level, plus per-level composition metrics."""
    import os

    from ..engine.em import load_relevant_taxon_info

    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    mappable = set(load_relevant_taxon_info(db_dir, set()))

    truth_abs = {}
    with open(truth_file) as f:
        for line in f:
            rid, taxon = line.rstrip("\n").split("\t")
            truth_abs[rid] = taxon
    inferred = {}
    with open(mappings_prefix + ".EM.reads2Taxon") as f:
        for line in f:
            rid, taxon = line.rstrip("\n").split("\t")
            inferred[rid] = taxon

    if truth_mapping_db is None:
        truth_mapping_db = {
            r: (t if t in mappable or t == "0" else t) for r, t in truth_abs.items()
        }

    reads = read_level_comparison(taxonomy, truth_abs, truth_mapping_db, inferred, mappable)

    truth_dist = truth_distribution(
        taxonomy, {r: truth_mapping_db[r] for r in truth_abs}, mappable
    )
    inferred_dist = parse_wimp(mappings_prefix + ".EM.WIMP")
    dist = {}
    for level in truth_dist:
        if level in ("absolute", "strain"):
            inf_level = inferred_dist.get("definedGenomes", {})
        else:
            inf_level = inferred_dist.get(level, {})
        if inf_level:
            dist[level] = distribution_level_comparison(truth_dist[level], inf_level)
    return {"reads": reads, "distribution": dist}
