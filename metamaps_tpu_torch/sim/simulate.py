"""Read simulation and experiment harness — simulate.pl equivalent.

Simulates long reads with a PBSIM-CLR-like error model (default accuracy
0.88, mean length 5000 — simulate.pl:41,57), tracks per-read truth, builds
leave-one-out "reduced DB" variants (produceReducedDB, simulate.pl:1966),
and runs the engine's mapDirectly + classify over each variant
(doMetaMap, simulate.pl:1583-1660 uses --all --pi 80 --minReadLen 2000).

Counterpart: ``metamaps_tpu/sim/simulate.py``, copied so that the port
imports nothing of the JAX package; :func:`run_inference` takes the port's
engine kinds (``torch``, the default, or ``oracle``; there is no ``auto``)
and a device, and raises where the original asserts.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..engine.em import load_relevant_taxon_info
from ..io.fasta import read_sequences

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class SimulatedRead:
    read_id: str
    seq: np.ndarray
    truth_taxon: str
    truth_contig: str
    truth_pos: int
    strand: int


def _revcomp(seq: np.ndarray) -> np.ndarray:
    lut = np.arange(256, dtype=np.uint8)
    for a, b in [(65, 84), (67, 71)]:
        lut[a], lut[b] = b, a
    return lut[seq][::-1]


def apply_error_model(rng, seq: np.ndarray, accuracy: float = 0.88,
                      sub_frac: float = 0.25, ins_frac: float = 0.25,
                      del_frac: float = 0.5) -> np.ndarray:
    """CLR-like errors: total error rate 1-accuracy split into
    substitutions/insertions/deletions (PBSIM defaults weighted toward
    indels for CLR chemistry)."""
    err = 1.0 - accuracy
    p_sub, p_ins, p_del = err * sub_frac, err * ins_frac, err * del_frac
    r = rng.random(len(seq))
    out = []
    for i, b in enumerate(seq):
        x = r[i]
        if x < p_del:
            continue
        if x < p_del + p_ins:
            out.append(rng.choice(_BASES))
            out.append(b)
        elif x < p_del + p_ins + p_sub:
            out.append(rng.choice(_BASES[_BASES != b]))
        else:
            out.append(b)
    return np.array(out, dtype=np.uint8)


def simulate_reads(
    db_dir: str,
    n_reads: int,
    rng,
    abundances: Optional[Dict[str, float]] = None,
    mean_length: int = 5000,
    min_length: int = 2000,
    accuracy: float = 0.88,
    rc_prob: float = 0.5,
) -> List[SimulatedRead]:
    """Simulate reads from the DB's genomes with given taxon abundances
    (uniform over taxa by default); read lengths ~ shifted exponential with
    the target mean."""
    taxon_info = load_relevant_taxon_info(db_dir, set())
    contigs: Dict[str, np.ndarray] = {}
    for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
        contigs[name] = seq

    taxa = sorted(taxon_info)
    if abundances is None:
        probs = np.full(len(taxa), 1.0 / len(taxa))
    else:
        probs = np.array([abundances.get(t, 0.0) for t in taxa])
        probs = probs / probs.sum()

    reads = []
    for i in range(n_reads):
        taxon = taxa[rng.choice(len(taxa), p=probs)]
        contig_ids = list(taxon_info[taxon])
        lens = np.array([taxon_info[taxon][c] for c in contig_ids], float)
        contig = contig_ids[rng.choice(len(contig_ids), p=lens / lens.sum())]
        g = contigs[contig]
        L = min(int(min_length + rng.exponential(max(1, mean_length - min_length))),
                len(g))
        pos = int(rng.integers(0, len(g) - L + 1))
        raw = g[pos : pos + L]
        strand = 1
        if rng.random() < rc_prob:
            raw = _revcomp(raw)
            strand = -1
        seq = apply_error_model(rng, raw, accuracy=accuracy)
        reads.append(SimulatedRead(f"simRead{i}", seq, taxon, contig, pos, strand))
    return reads


def write_simulation(reads: List[SimulatedRead], out_prefix: str):
    """FASTQ + truth table (readID -> taxonID)."""
    with open(out_prefix + ".fastq", "w") as fq:
        for r in reads:
            fq.write(f"@{r.read_id}\n{r.seq.tobytes().decode()}\n+\n")
            fq.write("I" * len(r.seq) + "\n")
    with open(out_prefix + ".truth", "w") as t:
        for r in reads:
            t.write(f"{r.read_id}\t{r.truth_taxon}\n")


def produce_reduced_db(db_dir: str, out_dir: str, remove_taxa: List[str],
                       taxonomy_dir: Optional[str] = None):
    """Leave-one-out DB variant: drop the given taxa's contigs
    (produceReducedDB, simulate.pl:1966)."""
    from ..db.build_db import build_db

    remove = set(remove_taxa)
    os.makedirs(out_dir, exist_ok=True)
    tmp_fa = os.path.join(out_dir, "_input.fa")
    kept = 0
    from ..taxonomy import extract_taxon_id

    with open(tmp_fa, "w") as out:
        for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
            if extract_taxon_id(name) in remove:
                continue
            kept += 1
            out.write(f">{name}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 80):
                out.write(s[i : i + 80] + "\n")
    assert kept > 0, "reduced DB would be empty"
    build_db([tmp_fa], out_dir, os.path.join(db_dir, "taxonomy"))
    os.remove(tmp_fa)
    return out_dir


def run_inference(db_dir: str, reads_fastq: str, out_prefix: str,
                  min_read_len: int = 2000, engine: str = "torch",
                  device: str = "cuda", stats: dict = None) -> str:
    """mapDirectly --all --pi 80 + classify (doMetaMap, simulate.pl:1583),
    through the port's CLI: the mapping engine ``engine`` (``torch`` or
    ``oracle``) and the EM rounds on ``device``, which raises without CUDA
    unless it is ``cpu``. ``stats``, when given, accumulates the mapping
    engine's counters and gets the wall seconds of ``mapDirectly`` and
    ``classify`` (``mapDirectly_s``, ``classify_s``)."""
    from ..cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main([
        "mapDirectly", "--reference", os.path.join(db_dir, "DB.fa"),
        "--query", reads_fastq, "--output", out_prefix, "--all",
        "--minReadLen", str(min_read_len), "--mapping-engine", engine,
        "--device", device,
    ], engine_stats=stats)
    if rc != 0:
        raise RuntimeError(f"mapDirectly on {reads_fastq} exited with {rc}")
    t1 = time.perf_counter()
    rc = cli_main(["classify", "--DB", db_dir, "--mappings", out_prefix,
                   "--device", device])
    if rc != 0:
        raise RuntimeError(f"classify of {out_prefix} exited with {rc}")
    if stats is not None:
        stats["mapDirectly_s"] = t1 - t0
        stats["classify_s"] = time.perf_counter() - t1
    return out_prefix
