"""Truth-set construction helpers — generic equivalents of the reference's
dataset-specific builders (util/truthForHMP.pl, truthForZymo.pl,
truthForCAMI.pl, evaluateExternalDatasets.pl).

Real mock-community truth sets map read identifiers (or their source
accessions) to taxon IDs. These helpers cover the shared mechanics: mapping
accessions to taxa via a lookup table, projecting truth taxa into a
database's taxonomy (the 'truth within the mapping DB' used by
validation.pm), and writing the two-column truth tables the evaluation
harness consumes.

Counterpart: ``metamaps_tpu/sim/truth.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Set, Tuple

from ..taxonomy import Taxonomy


def truth_from_read_headers(
    read_ids: Iterable[str],
    accession_to_taxon: Dict[str, str],
    pattern: Optional[str] = None,
) -> Dict[str, str]:
    """Derive per-read truth by extracting the source accession from each
    read id and mapping it through the table; unmatched reads map to '0'.

    Without a pattern, the longest separator-delimited prefix ('_' or '/')
    present in the table wins (accessions themselves may contain '_'). With
    a pattern, group 1 is the accession."""
    out = {}
    rx = re.compile(pattern) if pattern else None
    for rid in read_ids:
        taxon = "0"
        if rx is not None:
            m = rx.match(rid)
            if m:
                taxon = accession_to_taxon.get(m.group(1), "0")
        else:
            cuts = [i for i, c in enumerate(rid) if c in "_/"]
            for cut in sorted(cuts, reverse=True):
                if rid[:cut] in accession_to_taxon:
                    taxon = accession_to_taxon[rid[:cut]]
                    break
        out[rid] = taxon
    return out


def read_accession_table(path: str, acc_col: int = 0, taxon_col: int = 1,
                         sep: str = "\t") -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            fields = line.split(sep)
            out[fields[acc_col]] = fields[taxon_col]
    return out


def project_truth_into_db(
    truth_absolute: Dict[str, str],
    taxonomy: Taxonomy,
    mappable: Set[str],
) -> Dict[str, str]:
    """The 'truth within the mapping DB': each absolute truth taxon is
    replaced by itself when directly mappable, else by its closest mappable
    ancestor-of-attachment (the node where a novel genome would attach), or
    '0' when no ancestor has mappable descendants."""
    mappable_up: Dict[str, str] = {}

    def resolve(taxon: str) -> str:
        if taxon in ("0", ""):
            return "0"
        # outdated NCBI IDs follow the merged.dmp chain first
        # (validation.pm:75 via taxTree::findCurrentNodeID)
        if taxonomy.merged and not taxonomy.know_node(taxon) and taxon not in mappable:
            try:
                taxon = taxonomy.find_current_node_id(taxon)
            except RuntimeError:
                pass
        if taxon in mappable:
            return taxon
        if taxon in mappable_up:
            return mappable_up[taxon]
        result = "0"
        if taxonomy.know_node(taxon):
            for anc in taxonomy.get_upward_nodes(taxon, include_start=True):
                desc = taxonomy.descendants(anc)
                if any(d in mappable for d in desc):
                    result = anc
                    break
        mappable_up[taxon] = result
        return result

    return {rid: resolve(t) for rid, t in truth_absolute.items()}


def write_truth(truth: Dict[str, str], path: str):
    with open(path, "w") as f:
        for rid in truth:
            f.write(f"{rid}\t{truth[rid]}\n")
    return path


# --- dataset-specific truth builders (util/truthFor*.pl) ---------------------


def _write_truth_outputs(read2taxon: Dict[str, str], out_prefix: str,
                         taxonomy: Optional[Taxonomy] = None,
                         mappable: Optional[Set[str]] = None):
    """Shared output layer of the truthFor* scripts: .perRead (readID ->
    taxonID) and, when a taxonomy is supplied, .distribution — per-level
    frequencies from read counts (simulation::
    truthReadFrequenciesFromReadCounts, truthForHMP.pl:441)."""
    with open(out_prefix + ".perRead", "w") as f:
        for rid in sorted(read2taxon):
            f.write(f"{rid}\t{read2taxon[rid]}\n")
    if taxonomy is not None:
        from .validation import truth_distribution

        if mappable is None:
            mappable = {t for t in read2taxon.values() if t != "0"}
        dist = truth_distribution(taxonomy, read2taxon, mappable)
        with open(out_prefix + ".distribution", "w") as f:
            f.write("AnalysisLevel\ttaxonID\tfraction\n")
            for level in sorted(dist):
                for t in sorted(dist[level]):
                    f.write(f"{level}\t{t}\t{dist[level][t]}\n")
    return out_prefix + ".perRead"


def truth_from_cami(reads_mapping_tsv: str, out_prefix: str,
                    taxonomy: Optional[Taxonomy] = None,
                    mappable: Optional[Set[str]] = None) -> str:
    """CAMI gold-standard truth (util/truthForCAMI.pl): parse
    reads_mapping.tsv (#anonymous_read_id, genome_id, tax_id, read_id) into
    .perRead/.distribution + .genomesOfOrigin."""
    read2taxon: Dict[str, str] = {}
    genome_of_read: Dict[str, str] = {}
    with open(reads_mapping_tsv) as f:
        header = f.readline().rstrip("\n").split("\t")
        assert header[0] == "#anonymous_read_id", header
        assert header[1] == "genome_id" and header[2] == "tax_id", header
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            read2taxon[fields[0]] = fields[2]
            genome_of_read[fields[0]] = fields[1]
    with open(out_prefix + ".genomesOfOrigin", "w") as f:
        genomes = {}
        for rid, g in genome_of_read.items():
            genomes.setdefault(g, set()).add(read2taxon[rid])
        for g in sorted(genomes):
            f.write(f"{g}\t{';'.join(sorted(genomes[g]))}\n")
    return _write_truth_outputs(read2taxon, out_prefix, taxonomy, mappable)


def _best_alignment_per_read(sam_path: str, contig_to_taxon) -> Dict[str, str]:
    """Best primary alignment per read from a SAM text file (mapq
    tiebreak), taxon via contig_to_taxon(contig) -> taxonID or None."""
    best: Dict[str, tuple] = {}
    with open(sam_path) as f:
        for line in f:
            if not line or line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 5:
                continue
            rid, flag, contig, mapq = (
                fields[0], int(fields[1]), fields[2], int(fields[4])
            )
            if flag & 0x904:  # unmapped / secondary / supplementary
                continue
            taxon = contig_to_taxon(contig)
            if taxon is None:
                continue
            if rid not in best or mapq > best[rid][0]:
                best[rid] = (mapq, taxon)
    return {rid: t for rid, (q, t) in best.items()}


def truth_from_zymo(reference_fa: str, alignments_sam: str, out_prefix: str,
                    taxonomy: Optional[Taxonomy] = None,
                    all_read_ids: Optional[Set[str]] = None) -> str:
    """Zymo mock-community truth (util/truthForZymo.pl): reference contigs
    carry tx<taxid>| prefixes; the truth of a read is the taxon of its best
    alignment. Reads without alignments map to 0."""
    import re

    from ..io.fasta import read_sequences

    contig2taxon: Dict[str, str] = {}
    for name, _seq in read_sequences(reference_fa):
        cid = name.split()[0]
        m = re.match(r"^tx(.+?)\|", cid)
        assert m, f"Zymo contig {cid} lacks the tx<taxid>| prefix"
        contig2taxon[cid] = m.group(1)

    read2taxon = _best_alignment_per_read(
        alignments_sam, lambda c: contig2taxon.get(c.split()[0])
    )
    for rid in all_read_ids or ():
        read2taxon.setdefault(rid, "0")
    return _write_truth_outputs(read2taxon, out_prefix, taxonomy)


def truth_from_hmp(alignments_sam: str, gi_to_taxon_tsv: str,
                   out_prefix: str,
                   taxonomy: Optional[Taxonomy] = None,
                   all_read_ids: Optional[Set[str]] = None) -> str:
    """HMP7 truth (util/truthForHMP.pl): alignments against the 7-organism
    reference whose contig IDs embed gi|<number>|; gi -> taxonID via a
    two-column table; best alignment per read wins; unaligned reads -> 0."""
    import re

    gi2taxon: Dict[str, str] = {}
    with open(gi_to_taxon_tsv) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            gi, taxon = line.split("\t")[:2]
            gi2taxon[gi] = taxon

    gi_re = re.compile(r"gi\|(\d+)\|")

    def contig_to_taxon(contig):
        m = gi_re.search(contig)
        assert m, f"HMP contig {contig} lacks a gi|<number>| field"
        return gi2taxon.get(m.group(1))

    read2taxon = _best_alignment_per_read(alignments_sam, contig_to_taxon)
    for rid in all_read_ids or ():
        read2taxon.setdefault(rid, "0")
    return _write_truth_outputs(read2taxon, out_prefix, taxonomy)
