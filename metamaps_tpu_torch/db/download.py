"""RefSeq/GenBank download — downloadRefSeq.pl equivalent.

The reference walks the NCBI FTP tree: it fetches ``taxdump.tar.gz`` and
extracts it into the taxonomy directory (downloadRefSeq.pl:62-84), then for
each target branch fetches ``assembly_summary.txt``, selects assemblies by
``assembly_level`` (``--skipIncompleteGenomes`` keeps only 'Complete
Genome', downloadRefSeq.pl:166-190), and downloads each assembly's
``*_genomic.fna.gz`` / ``*_genomic.gff.gz`` / ``*_protein.faa.gz`` (CDS/RNA
variants excluded) plus ``*_assembly_report.txt`` into
``<seqDir>/<branch>/<species>/<assembly_version>/``, resuming partial
transfers by size comparison (downloadRefSeq.pl:294-303) and logging
failures to ``report.txt`` (downloadRefSeq.pl:105+).

This module reproduces that selection + retrieval loop over HTTP(S) with
urllib (NCBI serves the same tree at https://ftp.ncbi.nlm.nih.gov).
``base_url`` can point at any mirror — the tests drive the full loop
against a local ``http.server`` fixture, since deployment images are often
egress-free. ``make_plan`` + ``write_manifest`` remain available for
mirror-side tooling.

Counterpart: ``metamaps_tpu/db/download.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import re
import tarfile
from dataclasses import dataclass, field
from typing import List, Optional

NCBI_FTP = "https://ftp.ncbi.nlm.nih.gov"
DEFAULT_BRANCHES = [
    "archaea", "bacteria", "fungi", "protozoa", "viral",
]  # reference default: refseq microbial branches (downloadRefSeq.pl:89)

# taxTree::getTaxonomyFileNames — files that must exist after extracting
# taxdump.tar.gz (perlLib/taxTree.pm)
TAXONOMY_FILES = ["names.dmp", "nodes.dmp", "merged.dmp", "delnodes.dmp"]

# genome-directory files worth fetching (downloadRefSeq.pl:272):
# _genomic.fna.gz OR _genomic.gff.gz OR _protein.faa.gz, excluding the
# _cds_from_ / _rna_from_g variants; plus the assembly report
GENOMIC_SUFFIXES = ("_genomic.fna.gz", "_genomic.gff.gz", "_protein.faa.gz")
EXCLUDE_PATTERNS = ("_cds_from_", "_rna_from_g")


@dataclass
class DownloadPlan:
    assembly_summaries: List[str]
    taxonomy_dump: str
    target_dir: str
    branches: List[str] = field(default_factory=lambda: list(DEFAULT_BRANCHES))
    base_url: str = NCBI_FTP
    section: str = "refseq"


def make_plan(target_dir: str, branches: Optional[List[str]] = None,
              section: str = "refseq", base_url: str = NCBI_FTP) -> DownloadPlan:
    branches = branches or DEFAULT_BRANCHES
    summaries = [
        f"{base_url}/genomes/{section}/{b}/assembly_summary.txt"
        for b in branches
    ]
    return DownloadPlan(
        assembly_summaries=summaries,
        taxonomy_dump=f"{base_url}/pub/taxonomy/taxdump.tar.gz",
        target_dir=target_dir,
        branches=list(branches),
        base_url=base_url,
        section=section,
    )


def write_manifest(plan: DownloadPlan, path: str):
    with open(path, "w") as f:
        f.write(plan.taxonomy_dump + "\n")
        for s in plan.assembly_summaries:
            f.write(s + "\n")
    return path


@dataclass
class FetchResult:
    assemblies_downloaded: int = 0
    assemblies_skipped: int = 0  # already complete locally
    files_downloaded: int = 0
    failures: List[str] = field(default_factory=list)
    taxonomy_dir: str = ""
    report_path: str = ""


def _urlopen(url: str, timeout: float):
    import urllib.request

    return urllib.request.urlopen(url, timeout=timeout)


def _remote_size(url: str, timeout: float) -> Optional[int]:
    """Content-Length via a HEAD-like probe (urllib GET, closed unread)."""
    try:
        with _urlopen(url, timeout) as r:
            cl = r.headers.get("Content-Length")
            return int(cl) if cl is not None else None
    except Exception:
        return None


def _download(url: str, dest: str, timeout: float, retries: int = 3):
    """Fetch url -> dest with resume-on-partial semantics: an existing file
    whose size matches the remote Content-Length is kept
    (downloadRefSeq.pl:300-303); anything else is re-fetched atomically via
    a .part temp file. Returns 'kept', 'fetched', or False on failure."""
    if os.path.exists(dest):
        want = _remote_size(url, timeout)
        if want is not None and os.path.getsize(dest) == want:
            return "kept"
    tmp = dest + ".part"
    for _attempt in range(retries):
        try:
            with _urlopen(url, timeout) as r, open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(tmp, dest)
            return "fetched"
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return False


def _species_safe(organism_name: str) -> str:
    """Perl's s/\\W/_/g (downlaodRefSeq.pl organism_name_safe)."""
    return re.sub(r"\W", "_", organism_name)


def parse_assembly_summary(path: str):
    """Parse an NCBI assembly_summary.txt: line 1 is a comment, line 2 the
    '#'-prefixed header, then tab-separated rows (downloadRefSeq.pl:166-
    190). Returns a list of dicts keyed by header fields."""
    rows = []
    with open(path) as f:
        lines = f.read().splitlines()
    header = None
    for ln in lines:
        if not ln:
            continue
        if ln.startswith("#"):
            header = ln.lstrip("# ").split("\t")
            continue
        if header is None:
            continue
        fields = ln.split("\t")
        if len(fields) != len(header):
            # tolerate ragged tails (the reference dies; partial mirrors
            # are common enough that a skip + report is more useful)
            continue
        rows.append(dict(zip(header, fields)))
    return rows


def fetch_taxonomy(plan: DownloadPlan, taxonomy_dir: str,
                   timeout: float = 360.0) -> None:
    """Download + extract taxdump.tar.gz and verify the expected dmp files
    exist (downloadRefSeq.pl:62-84)."""
    os.makedirs(taxonomy_dir, exist_ok=True)
    tgz = os.path.join(taxonomy_dir, "taxdump.tar.gz")
    if not _download(plan.taxonomy_dump, tgz, timeout):
        raise RuntimeError(f"cannot download {plan.taxonomy_dump}")
    with tarfile.open(tgz, "r:gz") as tf:
        tf.extractall(taxonomy_dir, filter="data")
    missing = [
        f for f in TAXONOMY_FILES
        if not os.path.exists(os.path.join(taxonomy_dir, f))
    ]
    if missing:
        raise RuntimeError(f"taxdump extraction incomplete: missing {missing}")


def fetch(plan: DownloadPlan,
          assembly_levels=("Complete Genome", "Chromosome"),
          taxonomy_dir: Optional[str] = None,
          include_suffixes=("_genomic.fna.gz", "_assembly_report.txt"),
          max_assemblies: Optional[int] = None,
          timeout: float = 360.0,
          progress: bool = False) -> FetchResult:
    """The reference's full selection + retrieval loop
    (downloadRefSeq.pl:86-355) over HTTP.

    For each branch: fetch assembly_summary.txt (kept if already local),
    select rows whose ``assembly_level`` is in ``assembly_levels`` (pass
    None to keep everything = the reference without --skipIncompleteGenomes)
    and that have an ``ftp_path``, then download each assembly's files into
    ``<target>/<branch>/<species_safe>/<assembly_version>/``. File names
    derive from the assembly version (``<asm>_genomic.fna.gz`` etc. — the
    NCBI per-assembly directory layout), so no directory listing is needed.
    Existing files with matching remote size are skipped (resume).
    ``max_assemblies`` bounds the run (smoke tests / partial mirrors).
    Failures are appended to ``<target>/report.txt`` and surfaced in the
    result, mirroring the reference's report stream."""
    res = FetchResult()
    os.makedirs(plan.target_dir, exist_ok=True)
    res.report_path = os.path.join(plan.target_dir, "report.txt")
    report = open(res.report_path, "a")

    if taxonomy_dir is not None:
        fetch_taxonomy(plan, taxonomy_dir, timeout)
        res.taxonomy_dir = taxonomy_dir

    try:
        for branch, summary_url in zip(plan.branches,
                                       plan.assembly_summaries):
            branch_dir = os.path.join(plan.target_dir, branch)
            os.makedirs(branch_dir, exist_ok=True)
            summary_local = os.path.join(branch_dir, "assembly_summary.txt")
            if not _download(summary_url, summary_local, timeout):
                report.write(
                    f"cannot fetch assembly summary {summary_url}\n")
                res.failures.append(summary_url)
                continue

            for row in parse_assembly_summary(summary_local):
                ftp_path = row.get("ftp_path", "")
                if not ftp_path or ftp_path == "na":
                    continue
                level = row.get("assembly_level", "")
                if assembly_levels is not None and level not in assembly_levels:
                    continue
                if (max_assemblies is not None
                        and res.assemblies_downloaded + res.assemblies_skipped
                        >= max_assemblies):
                    break
                # rebase the summary's URL onto our mirror root: the path
                # below /genomes/ is mirror-invariant
                m = re.search(r"(/genomes/.+)$", ftp_path)
                asm_url = (plan.base_url + m.group(1)) if m else ftp_path
                asm_version = asm_url.rstrip("/").rsplit("/", 1)[-1]
                species = _species_safe(
                    row.get("organism_name", "unknown_organism"))
                asm_dir = os.path.join(branch_dir, species, asm_version)
                os.makedirs(asm_dir, exist_ok=True)

                got_all = True
                new_files = 0
                for suffix in include_suffixes:
                    fname = asm_version + suffix
                    dest = os.path.join(asm_dir, fname)
                    ok = _download(f"{asm_url}/{fname}", dest, timeout)
                    if not ok:
                        report.write(
                            f"failed {asm_url}/{fname} (branch {branch})\n")
                        res.failures.append(f"{asm_url}/{fname}")
                        got_all = False
                    elif ok == "fetched":
                        new_files += 1
                        res.files_downloaded += 1
                if got_all and new_files == 0:
                    res.assemblies_skipped += 1
                elif got_all:
                    res.assemblies_downloaded += 1
                if progress:
                    print(
                        f"\r{branch}: {res.assemblies_downloaded} downloaded,"
                        f" {res.assemblies_skipped} already local",
                        end="", flush=True,
                    )
            if progress:
                print()
    finally:
        report.close()
    return res
