"""DB integrity checks and statistics — validateDB.pl / DBinfo.pl
equivalents.

Counterpart: ``metamaps_tpu/db/validate.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict

from ..io.fasta import read_sequences
from ..taxonomy import Taxonomy, extract_taxon_id
from ..engine.em import load_relevant_taxon_info


def validate_db(db_dir: str) -> Dict:
    """Check DB.fa contig lengths against taxonInfo.txt and taxonomy
    coverage; raises on inconsistency, returns summary stats."""
    taxon_info = load_relevant_taxon_info(db_dir, set())
    expected = {}
    for taxon, contigs in taxon_info.items():
        for contig, length in contigs.items():
            if contig in expected:
                raise RuntimeError(f"duplicate contig {contig}")
            expected[contig] = (taxon, length)

    seen = set()
    for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
        if name not in expected:
            raise RuntimeError(f"contig {name} in DB.fa but not taxonInfo.txt")
        taxon, length = expected[name]
        if len(seq) != length:
            raise RuntimeError(
                f"length mismatch for {name}: DB.fa {len(seq)} vs "
                f"taxonInfo {length}"
            )
        if extract_taxon_id(name) != taxon:
            raise RuntimeError(f"taxon mismatch for {name}")
        seen.add(name)
    missing = set(expected) - seen
    if missing:
        raise RuntimeError(f"contigs in taxonInfo but not DB.fa: {sorted(missing)[:5]}")

    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    for taxon in taxon_info:
        if not taxonomy.know_node(taxon):
            raise RuntimeError(f"taxon {taxon} not in taxonomy")

    return db_info(db_dir, taxon_info, taxonomy)


def db_info(db_dir: str, taxon_info=None, taxonomy=None) -> Dict:
    """Composition statistics (DBinfo.pl equivalent)."""
    if taxon_info is None:
        taxon_info = load_relevant_taxon_info(db_dir, set())
    if taxonomy is None:
        taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    total_bases = sum(l for c in taxon_info.values() for l in c.values())
    n_contigs = sum(len(c) for c in taxon_info.values())
    ranks = {}
    for taxon in taxon_info:
        for rank, node in taxonomy.get_upward_by_ranks(taxon).items():
            if node != "Undefined":
                ranks.setdefault(rank, set()).add(node)
    return {
        "n_taxa": len(taxon_info),
        "n_contigs": n_contigs,
        "total_bases": total_bases,
        "distinct_per_rank": {r: len(s) for r, s in sorted(ranks.items())},
    }
