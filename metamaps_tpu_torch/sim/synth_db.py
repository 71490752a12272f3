"""Structured synthetic database + ONT-like read generator for
realistic-scale benchmarking.

Uniform-random sequence has no repeat structure: every sketch hash is
~unique, the frequency threshold (winSketch.hpp:452-495) never fires and L1
yields ~1 candidate per read. This generator produces databases with the
structure that drives the reference's design (miniSeq+H facts: the
reference MetaMaps README.md:20,100):

- base genomes of random background sequence;
- a shared pool of homologous segments planted across genomes at 2-6%
  divergence (conserved genes across taxa -> multi-taxon L1 candidates);
- repeat families planted at high copy number with small divergence
  (exercises the top-0.001% minimizer frequency threshold);
- near-identical duplicated genomes (~0.5% divergence x-sibling analogs,
  annotateRefSeqSequencesWithUniqueTaxonIDs-style), so reads from them
  always carry >= 2 candidate locations.

Reads are ONT-like: substitutions + insertions + deletions.

Counterpart: ``metamaps_tpu/sim/synth_db.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_seq(rng, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def mutate_sub(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    out = seq.copy()
    m = rng.random(len(seq)) < rate
    out[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return out


def synth_structured_db(
    rng,
    total_bases: int = 1_000_000_000,
    n_base_genomes: int = 12,
    n_duplicated: int = 3,
    homolog_pool: int = 40,
    homolog_len: int = 20_000,
    homolog_divergence: Tuple[float, float] = (0.02, 0.06),
    repeat_families: int = 2,
    repeat_len: int = None,
    repeat_copies_per_genome: int = 40,
    repeat_divergence: float = 0.01,
    dup_divergence: float = 0.005,
) -> Tuple[List[np.ndarray], List[str]]:
    """Returns (genomes, contig_names). The duplicated genomes are appended
    after the base genomes; total length ~= total_bases."""
    base_len = total_bases // (n_base_genomes + n_duplicated)
    pool = [_random_seq(rng, homolog_len) for _ in range(homolog_pool)]
    if repeat_len is None:
        # size the repeat families to ~40% of the frequency-threshold
        # budget (to_ignore ~= uniques * 1e-5, winSketch.hpp:463): their
        # high-copy minimizers then land inside the culled top-0.001% —
        # the threshold FIRES (the quantity the uniform-random bench never
        # exercised) and L1 hit totals stay bounded, as on real references
        repeat_len = max(200, int(total_bases * 1.9e-6 / repeat_families * 2))
    repeats = [_random_seq(rng, repeat_len) for _ in range(repeat_families)]

    genomes: List[np.ndarray] = []
    names: List[str] = []
    for gi in range(n_base_genomes):
        g = _random_seq(rng, base_len)
        # homologous segments: each pool element planted with prob 1/2
        for seg in pool:
            if rng.random() < 0.5:
                d = rng.uniform(*homolog_divergence)
                pos = int(rng.integers(0, base_len - len(seg)))
                g[pos : pos + len(seg)] = mutate_sub(rng, seg, d)
        # repeat families at high copy number
        for fam in repeats:
            for _ in range(repeat_copies_per_genome):
                pos = int(rng.integers(0, base_len - len(fam)))
                g[pos : pos + len(fam)] = mutate_sub(
                    rng, fam, repeat_divergence
                )
        genomes.append(g)
        names.append(f"G{gi}|kraken:taxid|{1000 + gi}|chr")

    for di in range(n_duplicated):
        src = int(rng.integers(0, n_base_genomes))
        genomes.append(mutate_sub(rng, genomes[src], dup_divergence))
        names.append(f"G{n_base_genomes + di}_dup{src}"
                     f"|kraken:taxid|x{2000 + di}|chr")
    return genomes, names


def ont_read(rng, genome: np.ndarray, length: int, sub: float = 0.06,
             ins: float = 0.025, dele: float = 0.025) -> np.ndarray:
    """One ONT-like read: slice + substitutions + insertions + deletions
    (the PBSIM CLR regime simulate.pl:41-57 approximates: ~0.88 accuracy)."""
    pos = int(rng.integers(0, len(genome) - length))
    r = genome[pos : pos + length]
    keep = rng.random(length) >= dele
    r = r[keep]
    reps = 1 + (rng.random(len(r)) < ins).astype(np.int64)
    r = np.repeat(r, reps)
    m = rng.random(len(r)) < sub
    r = r.copy()
    r[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return r


def write_synth_db_dir(
    path: str,
    rng,
    n_genera: int = 36,
    species_per_genus: int = 3,
    genome_len: int = 120_000,
    intra_genus_divergence: float = 0.08,
    homolog_pool: int = 20,
    homolog_len: int = 8_000,
    n_phyla: int = 3,
) -> List[str]:
    """Write a complete synthetic database DIRECTORY at realistic taxonomy
    scale: the full L4->L2/L3 contract (DB.fa with kraken:taxid contig IDs,
    taxonInfo.txt, contigNstats_windowSize_1000.txt, taxonomy/ dmp files —
    buildDB.pl:470-593, taxTree.pm) over n_genera x species_per_genus
    genomes with genus-level clustering (species within a genus diverge
    ~intra_genus_divergence from a shared base genome) plus a cross-genus
    homologous-segment pool, so leave-one-out inference has realistic
    same-genus attractors for novel-read scoring
    (validation.pm readLevelComparison categories, :433).

    Returns the list of species taxon IDs (strings)."""
    import os

    os.makedirs(os.path.join(path, "taxonomy"), exist_ok=True)
    pool = [_random_seq(rng, homolog_len) for _ in range(homolog_pool)]

    def dmp_line(*fields):
        return "\t|\t".join(str(f) for f in fields) + "\t|\n"

    WINDOW = 1000
    species_taxa: List[str] = []
    names_f = open(os.path.join(path, "taxonomy", "names.dmp"), "w")
    nodes_f = open(os.path.join(path, "taxonomy", "nodes.dmp"), "w")
    names_f.write(dmp_line(1, "root", "", "scientific name"))
    nodes_f.write(dmp_line(1, 1, "no rank"))
    names_f.write(dmp_line(2, "Bacteria", "", "scientific name"))
    nodes_f.write(dmp_line(2, 1, "superkingdom"))
    for p in range(n_phyla):
        names_f.write(dmp_line(10 + p, f"Phylum{p}", "", "scientific name"))
        nodes_f.write(dmp_line(10 + p, 2, "phylum"))

    fa = open(os.path.join(path, "DB.fa"), "w")
    ti = open(os.path.join(path, "taxonInfo.txt"), "w")
    ns = open(os.path.join(path, "contigNstats_windowSize_1000.txt"), "w")
    gid0, sid0 = 100, 10_000
    for g in range(n_genera):
        genus_id = gid0 + g
        phylum = 10 + g % n_phyla
        names_f.write(dmp_line(genus_id, f"Genus{g}", "", "scientific name"))
        nodes_f.write(dmp_line(genus_id, phylum, "genus"))
        base = _random_seq(rng, genome_len)
        for seg in pool:
            if rng.random() < 0.3:
                pos = int(rng.integers(0, genome_len - len(seg)))
                base[pos : pos + len(seg)] = mutate_sub(
                    rng, seg, float(rng.uniform(0.02, 0.08)))
        for s in range(species_per_genus):
            sid = sid0 + g * species_per_genus + s
            species_taxa.append(str(sid))
            names_f.write(dmp_line(sid, f"Species_g{g}_s{s}", "",
                                   "scientific name"))
            nodes_f.write(dmp_line(sid, genus_id, "species"))
            genome = (base if s == 0
                      else mutate_sub(rng, base, intra_genus_divergence))
            cname = f"G{g}S{s}|kraken:taxid|{sid}|ACC{g}_{s}.1"
            fa.write(f">{cname}\n")
            seq = genome.tobytes().decode()
            for j in range(0, len(seq), 80):
                fa.write(seq[j : j + 80] + "\n")
            ti.write(f"{sid} {cname}={len(genome)}\n")
            nw = (len(genome) + WINDOW - 1) // WINDOW
            ns.write(f"{sid}\t{cname}\t" + ";".join(["0"] * nw) + "\n")
    for f in (fa, ti, ns, names_f, nodes_f):
        f.close()
    with open(os.path.join(path, "taxonomy", "merged.dmp"), "w") as f:
        f.write("")
    return species_taxa


def make_ont_reads(rng, genomes: List[np.ndarray], n_reads: int,
                   min_len: int = 3000, max_len: int = 8000,
                   sub: float = 0.06, ins: float = 0.025,
                   dele: float = 0.025) -> List[np.ndarray]:
    reads = []
    for _ in range(n_reads):
        g = genomes[int(rng.integers(0, len(genomes)))]
        L = int(rng.integers(min_len, max_len))
        reads.append(ont_read(rng, g, L, sub, ins, dele))
    return reads
