"""DB converters for competitor tools — convertMetaMapsTo{Kraken,
Centrifuge,Mash}.pl equivalents.

Each produces, from a MetaMaps DB directory, the input layout the competitor
tool's build step expects: Kraken/Kraken2 (library FASTA with kraken:taxid
headers + taxonomy), Centrifuge (seqid->taxid map + combined FASTA), and
Mash (one FASTA per genome). x-pseudo-nodes are lifted to their first real
ancestor since competitors use plain NCBI ids.

Counterpart: ``metamaps_tpu/tools/convert.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict

from ..io.fasta import read_sequences
from ..taxonomy import Taxonomy, extract_taxon_id


def _real_taxon(taxonomy: Taxonomy, taxon: str) -> str:
    return taxonomy.get_first_non_x_node(taxon) if "x" in taxon else taxon


def to_kraken(db_dir: str, out_dir: str):
    os.makedirs(os.path.join(out_dir, "library"), exist_ok=True)
    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    out_fa = os.path.join(out_dir, "library", "metamaps.fna")
    with open(out_fa, "w") as out:
        for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
            taxon = _real_taxon(taxonomy, extract_taxon_id(name))
            acc = name.split("|")[-1]
            out.write(f">{acc}|kraken:taxid|{taxon}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                out.write(s[i : i + 80] + "\n")
    # taxonomy passthrough (kraken-build expects taxonomy/ alongside)
    return out_fa


def to_centrifuge(db_dir: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    out_fa = os.path.join(out_dir, "input.fna")
    out_map = os.path.join(out_dir, "seqid2taxid.map")
    with open(out_fa, "w") as fa, open(out_map, "w") as mp:
        for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
            taxon = _real_taxon(taxonomy, extract_taxon_id(name))
            acc = name.split("|")[-1]
            fa.write(f">{acc}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                fa.write(s[i : i + 80] + "\n")
            mp.write(f"{acc}\t{taxon}\n")
    return out_fa, out_map


def to_mash(db_dir: str, out_dir: str):
    """One FASTA per taxon (mash sketches per genome)."""
    os.makedirs(out_dir, exist_ok=True)
    handles: Dict[str, object] = {}
    try:
        for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
            taxon = extract_taxon_id(name)
            if taxon not in handles:
                handles[taxon] = open(os.path.join(out_dir, f"{taxon}.fa"), "w")
            f = handles[taxon]
            f.write(f">{name}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                f.write(s[i : i + 80] + "\n")
    finally:
        for f in handles.values():
            f.close()
    return sorted(os.path.join(out_dir, f"{t}.fa") for t in handles)
