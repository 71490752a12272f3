"""Gene-level / functional analysis — geneLevelAnalysis.pl equivalent.

Intersects each read's best (highest-mapQ) location in the .EM mappings with
the database's gene annotations (DB_annotations.txt: ContigId, Start, Stop,
GeneName, GeneLocusTag, CDSProteinId, CDSProduct — buildDB.pl:322) and
aggregates per-gene read counts/median identity, plus per-annotation-type
(e.g. eggNOG/COG from DB_proteins.faa.annotated) read counts.

Outputs: <mappings>.EM.geneLevelAnalysis and
<mappings>.EM.proteins.<annotationType>.

Counterpart: ``metamaps_tpu/tools/gene_level.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..io.mappings import iter_reads_grouped


def _best_mapping(read_lines: List[str]):
    best = None
    for line in read_lines:
        f = line.split(" ")
        mapq = float(f[13])
        if best is None or mapq > best[3]:
            best = (f[5], int(f[7]), int(f[8]), mapq, float(f[9]) / 100.0)
    return best


def read_annotations(path: str):
    """DB_annotations.txt -> {contig: [(start, stop, gene_key)]},
    {gene_key: (name, locus, protein, product)}."""
    per_contig: Dict[str, List[Tuple[int, int, str]]] = {}
    gene_info: Dict[str, tuple] = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        assert header[0] == "ContigId"
        col = {name: i for i, name in enumerate(header)}
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fl = line.split("\t")
            contig = fl[col["ContigId"]]
            start = int(fl[col["Start"]])
            stop = int(fl[col["Stop"]])
            name = fl[col["GeneName"]]
            locus = fl[col["GeneLocusTag"]]
            protein = fl[col["CDSProteinId"]] if "CDSProteinId" in col else ""
            product = fl[col["CDSProduct"]] if "CDSProduct" in col else ""
            key = f"{name}//{locus}"
            per_contig.setdefault(contig, []).append((start, stop, key))
            gene_info[key] = (name, locus, protein, product)
    for contig in per_contig:
        per_contig[contig].sort()
    return per_contig, gene_info


# emapper table column -> annotation type (geneLevelAnalysis.pl:156-168)
_ANNOTATION_COLUMNS = [
    ("GO_terms", "GO"),
    ("KEGG_KOs", "KEGG"),
    ("BiGG_reactions", "BiGG"),
    ("OGs", "OG"),
    ("COG_cat", "COG"),
]


def read_protein_annotations(path: str) -> Dict[str, Dict[str, List[str]]]:
    """DB_proteins.faa.annotated: proteinId -> {annotationType: [values]}.

    Canonical format is the headered eggNOG table (ProteinID, GO_terms,
    KEGG_KOs, BiGG_reactions, OGs, COG_cat) produced by splitEggNog collect;
    values are comma-separated, whitespace-stripped and deduplicated
    (geneLevelAnalysis.pl:135-169). A headerless 3-column
    (proteinId, type, value...) form is also accepted."""
    out: Dict[str, Dict[str, List[str]]] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        first = f.readline().rstrip("\n")
        if first.startswith("ProteinID\t"):
            header = first.split("\t")
            col = {name: header.index(name) for name in dict(_ANNOTATION_COLUMNS)
                   if name in header}
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                pid = fields[0]
                if pid in out:
                    raise RuntimeError(
                        f"Protein annotation data defined more than once? {pid}"
                    )
                out[pid] = {}
                for name, atype in _ANNOTATION_COLUMNS:
                    if name not in col or col[name] >= len(fields):
                        continue
                    raw = fields[col[name]].replace(" ", "")
                    if not raw:
                        continue
                    values = list(dict.fromkeys(raw.split(",")))
                    out[pid][atype] = values
            return out
        # legacy 3-column form
        for line in [first] + f.readlines():
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) < 3:
                continue
            pid, atype = fields[0], fields[1]
            out.setdefault(pid, {}).setdefault(atype, []).extend(fields[2:])
    return out


def _overlapping(intervals: List[Tuple[int, int, str]], start: int, stop: int):
    out = []
    for s, e, key in intervals:
        if s <= stop and start <= e:
            out.append(key)
    return out


def gene_level_analysis(db_dir: str, mappings_prefix: str):
    em_file = mappings_prefix + ".EM"
    if not os.path.exists(em_file):
        raise RuntimeError(f"{em_file} missing — run classify first")
    ann_file = os.path.join(db_dir, "DB_annotations.txt")
    if not os.path.exists(ann_file):
        raise RuntimeError(f"gene-annotated database required ({ann_file} missing)")

    per_contig, gene_info = read_annotations(ann_file)
    protein_ann = read_protein_annotations(
        os.path.join(db_dir, "DB_proteins.faa.annotated")
    )

    gene_reads: Dict[str, List[float]] = {}
    annotation_counts: Dict[str, Dict[str, int]] = {}
    n_with = n_without = 0
    for read_lines in iter_reads_grouped(em_file):
        contig, start, stop, mapq, identity = _best_mapping(read_lines)
        if contig not in per_contig:
            n_without += 1
            continue
        n_with += 1
        local_types: Dict[str, set] = {}
        for key in _overlapping(per_contig[contig], start, stop):
            gene_reads.setdefault(key, []).append(identity)
            protein = gene_info[key][2]
            if protein and protein in protein_ann:
                for atype, values in protein_ann[protein].items():
                    local_types.setdefault(atype, set()).update(values)
        for atype, values in local_types.items():
            d = annotation_counts.setdefault(atype, {})
            for v in values:
                d[v] = d.get(v, 0) + 1

    out_file = em_file + ".geneLevelAnalysis"
    with open(out_file, "w") as out:
        out.write("GeneName\tGeneLocusTag\tProteinId\tProduct\tnReads\tmedianIdentity\n")
        for key in sorted(gene_reads):
            name, locus, protein, product = gene_info[key]
            idents = sorted(gene_reads[key])
            median = idents[len(idents) // 2]
            out.write(
                f"{name}\t{locus}\t{protein}\t{product}\t{len(idents)}\t{median:.6g}\n"
            )
    for atype, counts in annotation_counts.items():
        with open(f"{em_file}.proteins.{atype}", "w") as out:
            out.write("Annotation\tnReads\n")
            for v in sorted(counts):
                out.write(f"{v}\t{counts[v]}\n")
    return out_file, n_with, n_without
