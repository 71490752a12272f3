"""Low-identity WIMP filtering — util/filterLowIdentityEntities.pl
equivalent.

Uses .EM.lengthAndIdentitiesPerMappingUnit to find mapping units whose
median best-mapping identity is below the threshold; reads assigned to
those units become Unclassified, and a filtered WIMP
(.EM.WIMP.filteredByIdentity) plus reads2Taxon
(.EM.reads2Taxon.filteredByIdentity) are written with per-rank counts
recomputed from the surviving reads (reference :86-170).

Counterpart: ``metamaps_tpu/tools/wimp_filter.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, List

from ..taxonomy import RELEVANT_LEVEL_NAMES, Taxonomy, extract_taxon_id


def filter_low_identity(db_dir: str, mappings_prefix: str,
                        identity_threshold: float = 0.8):
    """identity_threshold in [0,1]."""
    thr = identity_threshold * 100.0
    fn_ident = mappings_prefix + ".EM.lengthAndIdentitiesPerMappingUnit"
    fn_r2t = mappings_prefix + ".EM.reads2Taxon"
    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))

    unit_identities: Dict[str, List[float]] = {}
    read_units: List[tuple] = []  # (readI order matches r2t mapped reads)
    with open(fn_ident) as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            unit = fields[1]
            identity = float(fields[3]) * 100.0
            unit_identities.setdefault(unit, []).append(identity)
            read_units.append(unit)

    remove_units = set()
    for unit, idents in unit_identities.items():
        si = sorted(idents)
        if si[len(si) // 2] < thr:
            remove_units.add(unit)

    # reads in .EM order correspond to the mapped reads of reads2Taxon
    reads_filtered: Dict[str, str] = {}
    kept_taxa_counts: Dict[str, int] = {}
    with open(fn_r2t) as f:
        i = 0
        for line in f:
            rid, taxon = line.rstrip("\n").split("\t")
            if taxon == "0":
                reads_filtered[rid] = "0"
                continue
            unit = read_units[i]
            i += 1
            if unit in remove_units:
                reads_filtered[rid] = "0"
            else:
                reads_filtered[rid] = taxon
                kept_taxa_counts[taxon] = kept_taxa_counts.get(taxon, 0) + 1

    total_reads = len(reads_filtered)
    out_wimp = mappings_prefix + ".EM.WIMP.filteredByIdentity"
    with open(out_wimp, "w") as out:
        out.write("AnalysisLevel\ttaxonID\tName\tAbsolute\tEMFrequency\tPotFrequency\n")
        per_level: Dict[str, Dict[str, int]] = {}
        for taxon, n in kept_taxa_counts.items():
            up = taxonomy.get_upward_by_ranks(taxon, RELEVANT_LEVEL_NAMES)
            up["definedGenomes"] = taxon
            for level, node in up.items():
                d = per_level.setdefault(level, {})
                d[node] = d.get(node, 0) + n
        n_unclassified = sum(1 for t in reads_filtered.values() if t == "0")
        for level in sorted(per_level):
            for node in sorted(per_level[level]):
                name = (
                    taxonomy.get_node(node).scientific_name
                    if node != "Undefined" else "Undefined"
                )
                n = per_level[level][node]
                out.write(
                    f"{level}\t{node}\t{name}\t{n}\tNA\t{n/total_reads:.6g}\n"
                )
            out.write(
                f"{level}\t0\tUnclassified\t{n_unclassified}\tNA\t"
                f"{n_unclassified/total_reads:.6g}\n"
            )

    out_r2t = mappings_prefix + ".EM.reads2Taxon.filteredByIdentity"
    with open(out_r2t, "w") as out:
        for rid, taxon in reads_filtered.items():
            out.write(f"{rid}\t{taxon}\n")
    return out_wimp, out_r2t, remove_units
