"""Database construction — buildDB.pl equivalent.

Builds a MetaMaps-format DB directory from taxon-annotated FASTA input
(contig IDs carrying ``kraken:taxid|<id>|``):

- DB.fa            — concatenated contigs (optionally shuffled)
- taxonInfo.txt    — ``taxonID contig1=len1;contig2=len2;...``
  (buildDB.pl:470-541)
- contigNstats_windowSize_1000.txt — per-1000bp-window N counts
  (buildDB.pl:544-593)
- taxonomy/        — names/nodes/merged dmp trimmed to the used taxa plus
  their ancestors (taxTree::trimTaxonomyInDir, taxTree.pm:310-392)

Counterpart: ``metamaps_tpu/db/build_db.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np

from ..io.fasta import read_sequences
from ..taxonomy import extract_taxon_id

N_WINDOW = 1000


def _count_ns(seq: np.ndarray) -> List[int]:
    out = []
    for start in range(0, len(seq), N_WINDOW):
        win = seq[start : start + N_WINDOW]
        out.append(int(np.sum((win == ord("N")) | (win == ord("n")))))
    return out


def parse_gff_annotations(gff_files: List[str]) -> List[tuple]:
    """Minimal GFF3 gene/CDS extraction (buildDB.pl:246-337): returns rows
    (contig, start, stop, gene_name, locus_tag, protein_id, product)."""
    rows = []
    genes: Dict[str, list] = {}
    cds: Dict[str, tuple] = {}
    for fn in gff_files:
        with open(fn) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 9:
                    continue
                contig, _, ftype, start, stop = fields[0], fields[1], fields[2], fields[3], fields[4]
                attrs = dict(
                    kv.split("=", 1) for kv in fields[8].split(";") if "=" in kv
                )
                if ftype == "gene":
                    gid = attrs.get("ID", f"{contig}:{start}-{stop}")
                    genes[gid] = [
                        contig, int(start), int(stop),
                        attrs.get("Name", gid), attrs.get("locus_tag", ""),
                    ]
                elif ftype == "CDS":
                    parent = attrs.get("Parent", "")
                    cds[parent] = (attrs.get("protein_id", ""), attrs.get("product", ""))
    for gid, g in genes.items():
        protein, product = cds.get(gid, ("", ""))
        rows.append((*g, protein, product))
    return rows


def build_db(
    input_fastas: List[str],
    out_dir: str,
    taxonomy_dir: str,
    shuffle_contigs: bool = False,
    seed: int = 0,
    gff_files: List[str] = None,
    protein_fastas: List[str] = None,
):
    """Create the DB directory. ``taxonomy_dir`` is copied and trimmed.
    When GFF files are given, DB_annotations.txt is produced for the
    gene-level analysis; protein FASTAs are concatenated into DB_proteins.fa
    deduplicated by short protein ID (buildDB.pl:341-382)."""
    os.makedirs(out_dir, exist_ok=True)

    if protein_fastas:
        seen_proteins = set()
        with open(os.path.join(out_dir, "DB_proteins.fa"), "w") as pout:
            for fn in protein_fastas:
                with open(fn) as f:
                    full_id, seq_parts = None, []

                    def flush():
                        if full_id is None:
                            return
                        short_id = full_id.split(" ", 1)[0]
                        if short_id not in seen_proteins:
                            seen_proteins.add(short_id)
                            pout.write(f">{full_id}\n" + "".join(seq_parts) + "\n")

                    for line in f:
                        line = line.rstrip("\n")
                        if not line:
                            continue
                        if line.startswith(">"):
                            flush()
                            full_id, seq_parts = line[1:], []
                        else:
                            seq_parts.append(line)
                    flush()

    contigs = []  # (contig_id, taxon_id, seq)
    for fn in input_fastas:
        for name, seq in read_sequences(fn):
            taxon_id = extract_taxon_id(name)
            contigs.append((name, taxon_id, seq))

    if shuffle_contigs:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(contigs))
        contigs = [contigs[i] for i in order]

    taxon_to_contigs: Dict[str, List] = {}
    with open(os.path.join(out_dir, "DB.fa"), "w") as fa, open(
        os.path.join(out_dir, f"contigNstats_windowSize_{N_WINDOW}.txt"), "w"
    ) as ns:
        for name, taxon_id, seq in contigs:
            fa.write(f">{name}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                fa.write(s[i : i + 80] + "\n")
            ns.write(
                f"{taxon_id}\t{name}\t" + ";".join(map(str, _count_ns(seq))) + "\n"
            )
            taxon_to_contigs.setdefault(taxon_id, []).append((name, len(seq)))

    with open(os.path.join(out_dir, "taxonInfo.txt"), "w") as ti:
        for taxon_id in taxon_to_contigs:  # insertion (= input) order
            entry = ";".join(f"{c}={l}" for c, l in taxon_to_contigs[taxon_id])
            ti.write(f"{taxon_id} {entry}\n")

    if gff_files:
        with open(os.path.join(out_dir, "DB_annotations.txt"), "w") as ann:
            ann.write(
                "ContigId\tStart\tStop\tGeneName\tGeneLocusTag\t"
                "CDSProteinId\tCDSProduct\n"
            )
            for row in parse_gff_annotations(gff_files):
                ann.write("\t".join(map(str, row)) + "\n")

    # trimmed taxonomy
    out_tax = os.path.join(out_dir, "taxonomy")
    _copy_and_trim_taxonomy(taxonomy_dir, out_tax, set(taxon_to_contigs))
    return taxon_to_contigs


def _dmp_fields(line: str) -> List[str]:
    line = line.rstrip("\r\n")
    line = re.sub(r"\t?\|$", "", line)
    return line.split("\t|\t")


def _copy_and_trim_taxonomy(src: str, dst: str, keep_ids: set):
    """Trim names/nodes.dmp to keep_ids + ancestors (taxTree.pm:310-392);
    merged/delnodes copied through when present."""
    os.makedirs(dst, exist_ok=True)

    parents: Dict[str, str] = {}
    with open(os.path.join(src, "nodes.dmp")) as f:
        for line in f:
            if not line.strip():
                continue
            fields = _dmp_fields(line)
            parents[fields[0]] = fields[1]

    keep = set()
    for node in keep_ids:
        if node not in parents:
            raise RuntimeError(f"taxon {node} not in taxonomy {src}")
        cur = node
        while True:
            keep.add(cur)
            parent = parents[cur]
            if parent == cur or parent in ("0", "1"):
                keep.add(parent)
                break
            cur = parent
    keep.add("1")

    for fn in ("names.dmp", "nodes.dmp"):
        with open(os.path.join(src, fn)) as fin, open(
            os.path.join(dst, fn), "w"
        ) as fout:
            for line in fin:
                if not line.strip():
                    continue
                if _dmp_fields(line)[0] in keep:
                    fout.write(line)

    for fn in ("merged.dmp", "delnodes.dmp"):
        src_fn = os.path.join(src, fn)
        dst_fn = os.path.join(dst, fn)
        if os.path.exists(src_fn):
            shutil.copyfile(src_fn, dst_fn)
        elif fn == "merged.dmp":
            open(dst_fn, "w").close()
