"""Genome annotation with unique taxon IDs —
annotateRefSeqSequencesWithUniqueTaxonIDs.pl equivalent.

Rewrites contig headers to the MetaMaps contract
``C<n>|kraken:taxid|<taxonID>|<original header>`` and, when multiple genomes
map to the same taxon, creates 'x'-prefixed pseudo-nodes (rank
"pseudospecies") appended to the taxonomy's names.dmp/nodes.dmp
(reference: annotateRefSeq...pl:231-263, taxTree::storeXInDir,
taxTree.pm:184-240).

Counterpart: ``metamaps_tpu/db/annotate.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..io.fasta import read_sequences


def annotate_genomes(
    genome_files_with_taxa: List[Tuple[str, str]],
    out_fasta: str,
    taxonomy_dir: str,
    taxonomy_names: Dict[str, str] = None,
):
    """genome_files_with_taxa: [(fasta_path, taxon_id)]. Writes the combined
    annotated FASTA and appends x-pseudo-nodes to the taxonomy when a taxon
    has more than one genome. Returns {fasta_path: effective taxon id}."""
    by_taxon: Dict[str, List[str]] = {}
    for path, taxon in genome_files_with_taxa:
        by_taxon.setdefault(taxon, []).append(path)

    file_taxon: Dict[str, str] = {}
    x_nodes: List[Tuple[str, str]] = []  # (x_id, parent_taxon)
    running_x = 0
    for taxon, paths in by_taxon.items():
        if len(paths) == 1:
            file_taxon[paths[0]] = taxon
        else:
            for p in paths:
                running_x += 1
                x_id = f"x{running_x}"
                file_taxon[p] = x_id
                x_nodes.append((x_id, taxon))

    contig_counter = 0
    with open(out_fasta, "w") as out:
        for path, _ in genome_files_with_taxa:
            taxon = file_taxon[path]
            for name, seq in read_sequences(path):
                contig_counter += 1
                if "kraken:taxid" in name:
                    raise RuntimeError(f"{path}: contig already annotated: {name}")
                out.write(f">C{contig_counter}|kraken:taxid|{taxon}|{name}\n")
                s = seq.tobytes().decode()
                for i in range(0, len(s), 80):
                    out.write(s[i : i + 80] + "\n")

    if x_nodes:
        with open(os.path.join(taxonomy_dir, "names.dmp"), "a") as f:
            for x_id, parent in x_nodes:
                base = (taxonomy_names or {}).get(parent, f"taxon {parent}")
                f.write("\t|\t".join([x_id, f"{base} (genome {x_id})", "",
                                      "scientific name", ""]) + "\n")
        with open(os.path.join(taxonomy_dir, "nodes.dmp"), "a") as f:
            for x_id, parent in x_nodes:
                f.write("\t|\t".join([x_id, parent, "pseudospecies", ""]) + "\n")

    return file_taxon
