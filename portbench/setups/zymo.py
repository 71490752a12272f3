"""The ZymoBIOMICS Microbial Community Standard (D6300) as a mapping
database: its ten genomes (8 bacteria, 2 yeasts) at their documented
sizes and GC, each one contig of independent bases drawn from
``db_seed``, and the share of reads each genome gives, its stated share of
genomic DNA. Unrelated genomes share no segments, so a read meets about
one L1 candidate.
"""
from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def genomes(cfg: dict):
    """(genomes, contig names): genome i of ``cfg["genomes"]`` holds
    ``mbp`` million bases at GC share ``gc``."""
    rng = np.random.default_rng(cfg["db_seed"])
    seqs, names = [], []
    for i, g in enumerate(cfg["genomes"]):
        n = int(round(float(g["mbp"]) * 1e6))
        gc = float(g["gc"])
        cdf = np.array([(1 - gc) / 2, 0.5, 0.5 + gc / 2])  # A, C, G | T
        seqs.append(_BASES[np.searchsorted(cdf, rng.random(n), side="right")])
        names.append(f"{g['name']}|kraken:taxid|{g['taxid']}|Z{i}.1")
    return seqs, names


def read_shares(cfg: dict) -> np.ndarray:
    """Each genome's share of the reads: its ``dna_share`` (every genome
    gets the same read lengths, so reads follow DNA)."""
    share = np.array([float(g["dna_share"]) for g in cfg["genomes"]])
    return share / share.sum()
