"""Small DB utilities: shortenContigIDs.pl, combineAndAnnotateReferences.pl
and addTaxonIDToFasta.pl equivalents.

Counterpart: ``metamaps_tpu/tools/misc.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..io.fasta import read_sequences


def shorten_contig_ids(in_fasta: str, out_fasta: str, out_mapping: str):
    """Replace contig IDs with compact C<n>|kraken:taxid|<id>| forms while
    recording the translation (shortenContigIDs.pl)."""
    from ..taxonomy import extract_taxon_id

    n = 0
    with open(out_fasta, "w") as fa, open(out_mapping, "w") as mp:
        for name, seq in read_sequences(in_fasta):
            n += 1
            taxon = extract_taxon_id(name)
            acc = name.split("|")[-1].split()[0]
            new = f"C{n}|kraken:taxid|{taxon}|{acc}"
            mp.write(f"{name}\t{new}\n")
            fa.write(f">{new}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                fa.write(s[i : i + 80] + "\n")
    return n


def add_taxon_id_to_fasta(in_fasta: str, out_fasta: str, taxon_id: str):
    """Prefix every contig with kraken:taxid|<id>| (util/addTaxonIDToFasta.pl)."""
    n = 0
    with open(out_fasta, "w") as fa:
        for name, seq in read_sequences(in_fasta):
            n += 1
            fa.write(f">C{n}|kraken:taxid|{taxon_id}|{name}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                fa.write(s[i : i + 80] + "\n")
    return n


def combine_and_annotate(references: List[Tuple[str, str]], out_fasta: str):
    """Combine (fasta, taxonID) inputs into one annotated FASTA
    (combineAndAnnotateReferences.pl)."""
    n = 0
    with open(out_fasta, "w") as fa:
        for path, taxon in references:
            for name, seq in read_sequences(path):
                n += 1
                fa.write(f">C{n}|kraken:taxid|{taxon}|{name}\n")
                s = seq.tobytes().decode()
                for i in range(0, len(s), 80):
                    fa.write(s[i : i + 80] + "\n")
    return n
