"""Competitor tool integration — perlLib/SimulationsKraken.pm equivalents.

Runners shell out to kraken/kraken2/centrifuge/bracken when the binaries
are installed (the reference drives them the same way), and the output
converters translate their per-read classifications into the two-column
reads2Taxon format our evaluation harness consumes
(create_compatible_reads_file_from_* — SimulationsKraken.pm:1208-1420).

Counterpart: ``metamaps_tpu/tools/competitors.py``, copied unchanged so
that the port imports nothing of the JAX package. The database builders
convert through the port's ``tools/convert.py``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional


class CompetitorNotInstalled(RuntimeError):
    pass


def _require(binary: str) -> str:
    path = shutil.which(binary)
    if path is None:
        raise CompetitorNotInstalled(
            f"{binary} not found on PATH — install it or skip this comparison"
        )
    return path


def run_kraken(db_dir: str, reads: str, out_prefix: str, binary: str = "kraken2"):
    """Run kraken/kraken2 against a converted DB (tools.convert.to_kraken +
    kraken-build) and return the per-read output path."""
    bin_path = _require(binary)
    out = out_prefix + ".kraken.reads"
    subprocess.run(
        [bin_path, "--db", db_dir, "--output", out, reads], check=True
    )
    return out


def run_centrifuge(index_prefix: str, reads: str, out_prefix: str):
    bin_path = _require("centrifuge")
    out = out_prefix + ".centrifuge.reads"
    subprocess.run(
        [bin_path, "-x", index_prefix, "-U", reads, "-S", out, "-f"], check=True
    )
    return out


def kraken_reads_to_reads2taxon(kraken_reads: str, output_fn: str):
    """kraken per-read output (C/U, readID, taxID) -> reads2Taxon
    (SimulationsKraken.pm:1208-1244). Unclassified reads map to 0 and are
    also listed in <output>.unclassified."""
    with open(kraken_reads) as f, open(output_fn, "w") as out, open(
        output_fn + ".unclassified", "w"
    ) as out_u:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            classified, read_id, taxon = fields[0], fields[1], fields[2]
            assert classified in ("C", "U")
            if classified == "C":
                out.write(f"{read_id}\t{taxon}\n")
            else:
                out.write(f"{read_id}\t0\n")
                out_u.write(f"{read_id}\tUnclassified\n")
    return output_fn


def centrifuge_reads_to_reads2taxon(centrifuge_reads: str, output_fn: str,
                                    contig_to_taxon: Optional[Dict[str, str]] = None):
    """centrifuge per-read output -> reads2Taxon
    (SimulationsKraken.pm:1298-1420). Multiple hits per read: the first
    classification wins; seqID-based hits can be lifted through
    ``contig_to_taxon`` when taxID is 0."""
    seen = set()
    with open(centrifuge_reads) as f, open(output_fn, "w") as out, open(
        output_fn + ".unclassified", "w"
    ) as out_u:
        header = f.readline().rstrip("\n").split("\t")
        assert header[0] == "readID" and header[2] == "taxID"
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            read_id, seq_id, taxon = fields[0], fields[1], fields[2]
            if read_id in seen:
                continue
            seen.add(read_id)
            if taxon == "0" and contig_to_taxon:
                base = seq_id.split("|")[0]
                taxon = contig_to_taxon.get(base, "0")
            if seq_id == "unclassified" or taxon == "0":
                out.write(f"{read_id}\t0\n")
                out_u.write(f"{read_id}\tUnclassified\n")
            else:
                out.write(f"{read_id}\t{taxon}\n")
    return output_fn


# --- competitor DB builds (callKraken*OnConvertedDB.pl analogs) --------------


def build_kraken2_db(metamaps_db: str, out_dir: str,
                     kmer_len: int = 35, threads: int = 4):
    """Convert a MetaMaps DB and drive kraken2-build
    (convertMetaMapsToKraken.pl + callKraken2OnConvertedDB.pl:1-46 +
    SimulationsKraken.pm doKraken2)."""
    from .convert import to_kraken

    build = _require("kraken2-build")
    os.makedirs(out_dir, exist_ok=True)
    conv = os.path.join(out_dir, "_converted")
    to_kraken(metamaps_db, conv)
    tax_dir = os.path.join(out_dir, "taxonomy")
    os.makedirs(tax_dir, exist_ok=True)
    for dmp in ("names.dmp", "nodes.dmp", "merged.dmp"):
        src = os.path.join(metamaps_db, "taxonomy", dmp)
        if os.path.exists(src):
            shutil.copy(src, tax_dir)
    subprocess.run(
        [build, "--db", out_dir, "--add-to-library",
         os.path.join(conv, "DB.fa")], check=True,
    )
    subprocess.run(
        [build, "--db", out_dir, "--build", "--kmer-len", str(kmer_len),
         "--threads", str(threads)], check=True,
    )
    return out_dir


def build_centrifuge_index(metamaps_db: str, out_dir: str, threads: int = 4):
    """Convert a MetaMaps DB and drive centrifuge-build
    (convertMetaMapsToCentrifuge.pl + callCentrifugeOnConvertedDB.pl;
    SimulationsKraken.pm:128)."""
    from .convert import to_centrifuge

    build = _require("centrifuge-build")
    os.makedirs(out_dir, exist_ok=True)
    conv = os.path.join(out_dir, "_converted")
    to_centrifuge(metamaps_db, conv)
    prefix = os.path.join(out_dir, "DB")
    subprocess.run(
        [build, "-p", str(threads),
         "--conversion-table", os.path.join(conv, "conversion.tsv"),
         "--taxonomy-tree", os.path.join(metamaps_db, "taxonomy", "nodes.dmp"),
         "--name-table", os.path.join(metamaps_db, "taxonomy", "names.dmp"),
         os.path.join(conv, "DB.fa"), prefix], check=True,
    )
    return prefix


# --- kraken2 with report + Bracken (SimulationsKraken.pm:220-335) ------------


def run_kraken2_with_report(db_dir: str, reads: str, out_prefix: str):
    """kraken2 producing both the per-read file and the report (the report
    feeds Bracken)."""
    bin_path = _require("kraken2")
    out_reads = out_prefix + ".kraken.reads"
    out_report = out_prefix + ".kraken.report"
    subprocess.run(
        [bin_path, "--db", db_dir, "--output", out_reads,
         "--report", out_report, reads], check=True,
    )
    return out_reads, out_report


def run_bracken(kraken_db: str, report: str, out_prefix: str,
                levels=("S", "G", "F"), read_len: int = 75):
    """bracken per level (SimulationsKraken.pm:307 est_abundance); returns
    {level: output file}."""
    bin_path = _require("bracken")
    out = {}
    for lv in levels:
        fn = f"{out_prefix}.bracken_{lv}"
        subprocess.run(
            [bin_path, "-d", kraken_db, "-i", report, "-l", lv,
             "-r", str(read_len), "-o", fn], check=True,
        )
        out[lv] = fn
    return out


def parse_kraken_report_totals(report_fn: str):
    """(n_unclassified, n_root) from a kraken report
    (SimulationsKraken.pm:678-700: the 'unclassified' and 'root' rows)."""
    n_unclassified = None
    n_root = None
    with open(report_fn) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            name = fields[5].strip()
            if name == "unclassified":
                assert n_unclassified is None
                n_unclassified = int(fields[1])
            elif name == "root":
                assert n_root is None
                n_root = int(fields[1])
    if n_unclassified is None:
        n_unclassified = 0
    assert n_root is not None, f"no root row in {report_fn}"
    return n_unclassified, n_root


def kraken_to_composition(report_fn: str, reads_fn: str, taxonomy,
                          mappable, output_fn: str):
    """Per-level composition table from kraken per-read output
    (create_compatible_file_from_kraken, SimulationsKraken.pm:664-810):
    classified reads are lifted per evaluation level, frequencies over ALL
    reads; writes <out> and <out>.ignoreUnclassified (frequencies over
    classified reads only). Format: AnalysisLevel ID Name Absolute
    PotFrequency."""
    from ..sim.validation import EVALUATION_LEVELS, lightning

    n_unclassified, n_root = parse_kraken_report_totals(report_fn)
    n_total = n_unclassified + n_root
    assert n_total > 0

    reads_at: dict = {}
    n_uncl_check = 0
    cache = {}
    with open(reads_fn) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            classified, _, taxon = fields[0], fields[1], fields[2]
            assert classified in ("C", "U")
            if classified == "U":
                n_uncl_check += 1
                continue
            if taxon not in cache:
                cache[taxon] = (
                    lightning(taxonomy, taxon, mappable)
                    if taxonomy.know_node(taxon)
                    else {lv: "Unclassified" for lv in
                          ["absolute"] + list(EVALUATION_LEVELS)}
                )
            lt = cache[taxon]
            reads_at.setdefault("definedAndHypotheticalGenomes", {})
            reads_at["definedAndHypotheticalGenomes"][taxon] = (
                reads_at["definedAndHypotheticalGenomes"].get(taxon, 0) + 1
            )
            for rank in EVALUATION_LEVELS:
                reads_at.setdefault(rank, {})
                reads_at[rank][lt[rank]] = reads_at[rank].get(lt[rank], 0) + 1
    assert n_uncl_check == n_unclassified, (
        f"unclassified mismatch: {n_uncl_check} vs report {n_unclassified}"
    )

    def name_of(t):
        return (taxonomy.get_node(t).scientific_name
                if taxonomy.know_node(t) else t)

    with open(output_fn, "w") as out, open(
        output_fn + ".ignoreUnclassified", "w"
    ) as out2:
        hdr = "AnalysisLevel\tID\tName\tAbsolute\tPotFrequency\n"
        out.write(hdr)
        out2.write(hdr)
        for level in sorted(reads_at):
            level_total = sum(reads_at[level].values())
            for t in sorted(reads_at[level]):
                n = reads_at[level][t]
                out.write(f"{level}\t{t}\t{name_of(t)}\t{n}\t{n / n_total}\n")
                out2.write(f"{level}\t{t}\t{name_of(t)}\t{n}\t{n / n_root}\n")
            n_uncl_level = n_total - level_total
            out.write(f"{level}\tUnclassified\tUnclassified\t"
                      f"{n_uncl_level}\t{n_uncl_level / n_total}\n")
            n_uncl_level2 = n_root - level_total
            out2.write(f"{level}\tUnclassified\tUnclassified\t"
                       f"{n_uncl_level2}\t{n_uncl_level2 / n_root}\n")
    return output_fn


def bracken_to_composition(report_fn: str, bracken_files, taxonomy,
                           output_fn: str):
    """Bracken per-level abundances -> composition table
    (create_compatible_file_from_kraken_bracken,
    SimulationsKraken.pm:1421-1580). bracken_files: {rank_name: file} with
    rank_name in ('species', 'genus', 'family'); writes <out> and
    <out>.ignoreUnclassified."""
    n_unclassified, n_root = parse_kraken_report_totals(report_fn)
    n_total = n_unclassified + n_root

    def read_s(fn, rank, ignore_unclassified):
        s = {}
        n_classified = 0
        with open(fn) as f:
            header = f.readline().rstrip("\n").split("\t")
            assert header[1] == "taxonomy_id"
            assert header[5] == "new_est_reads"
            assert header[6] == "fraction_total_reads"
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                taxon, n_reads = fields[1], int(fields[5])
                assert taxonomy.know_node(taxon), taxon
                assert taxonomy.get_node(taxon).rank == rank, taxon
                denom = n_root if ignore_unclassified else n_total
                a = s.setdefault(taxon, [0, 0.0])
                a[0] += n_reads
                a[1] += n_reads / denom
                n_classified += n_reads
        denom = n_root if ignore_unclassified else n_total
        n_uncl = denom - n_classified
        s["Unclassified"] = [n_uncl, n_uncl / denom]
        return s

    with open(output_fn, "w") as out, open(
        output_fn + ".ignoreUnclassified", "w"
    ) as out2:
        hdr = "AnalysisLevel\tID\tName\tAbsolute\tPotFrequency\n"
        out.write(hdr)
        out2.write(hdr)
        for rank, fn in sorted(bracken_files.items()):
            for dest, ignore in ((out, False), (out2, True)):
                s = read_s(fn, rank, ignore)
                for t in sorted(s):
                    name = (taxonomy.get_node(t).scientific_name
                            if t != "Unclassified" and taxonomy.know_node(t)
                            else t)
                    dest.write(
                        f"{rank}\t{t}\t{name}\t{s[t][0]}\t{s[t][1]}\n"
                    )
    return output_fn


# --- MEGAN (doMegan, SimulationsKraken.pm:372-436,529-597) -------------------


def run_megan(reads_fasta: str, protein_db_dmnd: str, out_prefix: str,
              megan_dir: str = None, threads: int = 4):
    """diamond blastx -> daa2rma -> rma2info read->taxon assignments. All
    three binaries must be installed (the reference stages the same
    pipeline against the DB's protein FASTA)."""
    diamond = _require("diamond")
    daa2rma = _require(os.path.join(megan_dir, "daa2rma") if megan_dir
                       else "daa2rma")
    rma2info = _require(os.path.join(megan_dir, "rma2info") if megan_dir
                        else "rma2info")
    daa = out_prefix + ".daa"
    subprocess.run(
        [diamond, "blastx", "-d", protein_db_dmnd, "-q", reads_fasta,
         "-a", daa, "-p", str(threads)], check=True,
    )
    rma = out_prefix + ".rma"
    subprocess.run([daa2rma, "--in", daa, "--out", rma], check=True)
    out = out_prefix + ".megan.reads"
    with open(out, "w") as f:
        subprocess.run(
            [rma2info, "--in", rma, "-r2c", "Taxonomy"], check=True, stdout=f
        )
    return out


def megan_reads_to_reads2taxon(megan_reads: str, output_fn: str,
                               all_read_ids=None):
    """MEGAN rma2info read->taxon pairs -> reads2Taxon
    (create_compatible_reads_file_from_megan,
    SimulationsKraken.pm:1246-1297): taxon -2 and reads missing from the
    output map to 0 (+ .unclassified sidecar)."""
    seen = set()
    with open(megan_reads) as f, open(output_fn, "w") as out, open(
        output_fn + ".unclassified", "w"
    ) as out_u:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            assert len(fields) == 2, f"weird MEGAN line: {line!r}"
            read_id, taxon = fields
            assert taxon == "-2" or int(taxon) > 0
            seen.add(read_id)
            if taxon != "-2":
                out.write(f"{read_id}\t{taxon}\n")
            else:
                out.write(f"{read_id}\t0\n")
                out_u.write(f"{read_id}\tUnclassified\n")
        for read_id in sorted(all_read_ids or []):
            if read_id not in seen:
                out.write(f"{read_id}\t0\n")
                out_u.write(f"{read_id}\tUnclassified\n")
    return output_fn


# --- classic Kraken-1 (SimulationsKraken.pm doKraken:598-631,
# translateMetaMapToKraken:199-290, doKrakenOnExistingDB:336-404) -------------


def build_kraken1_db(metamaps_db: str, out_dir: str, threads: int = 4):
    """Convert a MetaMaps DB and drive classic kraken-build
    (translateMetaMapToKraken, SimulationsKraken.pm:199-290): taxonomy dmp
    files + DB.fa library -> kraken-build --build. The resulting DB/ dir
    is what run_kraken1 consumes."""
    from .convert import to_kraken

    build = _require("kraken-build")
    os.makedirs(out_dir, exist_ok=True)
    conv = os.path.join(out_dir, "_converted")
    to_kraken(metamaps_db, conv)
    db = os.path.join(out_dir, "DB")
    tax_dir = os.path.join(db, "taxonomy")
    os.makedirs(tax_dir, exist_ok=True)
    for dmp in ("names.dmp", "nodes.dmp", "merged.dmp"):
        src = os.path.join(metamaps_db, "taxonomy", dmp)
        if os.path.exists(src):
            shutil.copy(src, tax_dir)
    subprocess.run(
        [build, "--db", db, "--add-to-library",
         os.path.join(conv, "DB.fa")], check=True,
    )
    subprocess.run(
        [build, "--db", db, "--build", "--threads", str(threads)],
        check=True,
    )
    return db


def run_kraken1(db_dir: str, reads: str, out_prefix: str, threads: int = 4):
    """Classic kraken + kraken-report (doKrakenOnExistingDB,
    SimulationsKraken.pm:336-404). The per-read output is the same
    C/U<TAB>readID<TAB>taxonID shape as kraken2, so
    kraken_reads_to_reads2taxon / kraken_to_composition apply unchanged."""
    kraken = _require("kraken")
    report_bin = _require("kraken-report")
    out_reads = out_prefix + ".kraken.reads"
    out_report = out_prefix + ".kraken.report"
    subprocess.run(
        [kraken, "--preload", "--db", db_dir, "--threads", str(threads),
         "--output", out_reads, reads], check=True,
    )
    with open(out_report, "w") as rep:
        subprocess.run(
            [report_bin, "--db", db_dir, out_reads], check=True, stdout=rep,
        )
    return out_reads, out_report


# --- MetaPalette (SimulationsMetaPalette.pm:1-156) ---------------------------


def run_metapalette(install_dir: str, reads_fastq: str, out_dir: str,
                    jellyfish_bin: str = "jellyfish", threads: int = 16):
    """Drive MetaPalette's Classify.py against its bacteria DB
    (doMetaPalette, SimulationsMetaPalette.pm:11-78): quality offset from
    the reads' first-quartile score, sensitive k-mer mode. Returns the
    .profile path."""
    from .reads_util import first_quartile_quality

    classify = os.path.join(install_dir, "src", "Python", "Classify.py")
    bacteria_db = os.path.join(install_dir, "Bacteria")
    query_per_seq = os.path.join(
        install_dir, "src", "QueryPerSeq", "query_per_sequence"
    )
    for path in (classify, bacteria_db, query_per_seq):
        if not os.path.exists(path):
            raise CompetitorNotInstalled(
                f"MetaPalette component missing: {path}"
            )
    os.makedirs(out_dir, exist_ok=True)
    q = first_quartile_quality(reads_fastq)
    subprocess.run(
        ["python", classify, "-d", bacteria_db, "-o", out_dir,
         "-i", os.path.abspath(reads_fastq), "-Q", str(q),
         "-k", "sensitive", "-j", jellyfish_bin, "-q", query_per_seq,
         "-t", str(threads), "-n"],
        check=True, cwd=os.path.dirname(classify),
    )
    return os.path.join(out_dir, os.path.basename(reads_fastq) + ".profile")


def metapalette_to_composition(profile_fn: str, taxonomy, output_fn: str):
    """MetaPalette .profile -> compatible composition table
    (create_compatible_file_from_metapalette,
    SimulationsMetaPalette.pm:80-155): 5-field rows (taxonID, level, .., ..,
    percentage); merged IDs follow merged.dmp; percentages /100 accumulate
    per REAL rank; each level's missing mass becomes Unclassified."""
    s_by_level = {}
    with open(profile_fn) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line[0] in "#@":
                continue
            fields = line.split("\t")
            assert len(fields) == 5, f"weird MetaPalette line: {line!r}"
            taxon, level, _, _, pct = fields
            current = taxonomy.find_current_node_id(taxon)
            real_rank = taxonomy.get_node(current).rank
            if real_rank and real_rank != "no rank":
                d = s_by_level.setdefault(real_rank, {})
                d[current] = d.get(current, 0.0) + float(pct) / 100.0
    with open(output_fn, "w") as out:
        out.write(
            "AnalysisLevel\ttaxonID\tName\tAbsolute\tPotFrequency\n"
        )
        for level in sorted(s_by_level):
            total = sum(s_by_level[level].values())
            assert 0.0 <= total <= 1.0 + 1e-9
            rows = dict(s_by_level[level])
            rows["Unclassified"] = max(0.0, 1.0 - total)
            for taxon in sorted(rows):
                if taxon == "Unclassified":
                    name, tid = "Unclassified", "0"
                else:
                    name, tid = taxonomy.get_node(taxon).scientific_name, taxon
                out.write(f"{level}\t{tid}\t{name}\t0\t{rows[taxon]}\n")
    return output_fn
