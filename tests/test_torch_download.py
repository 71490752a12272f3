"""The port's ``downloadRefSeq`` (``db/download.py``) against the JAX
package's, on a copy of the local NCBI mirror of ``tests/test_download.py``
(served on 127.0.0.1: two bacteria, one Complete Genome and one
Chromosome, one Scaffold-level assembly, and pub/taxonomy/taxdump.tar.gz;
nothing here reaches another host): the manifest, the full fetch with the
taxonomy, a resumed fetch after a truncated file, missing files, every
assembly level, ``max_assemblies``, a summary that cannot be fetched, and
the CLI's ``--fetch --baseUrl`` with ``--skipIncompleteGenomes`` and
``--maxAssemblies``; and ``parse_assembly_summary``. Each package runs in
its own directory on the same relative paths; the results, every file and
every printed line must be the other's."""
import dataclasses
import gzip
import http.server
import os
import tarfile
import threading

import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.db import download as jax_download
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.db import download as port_download

from util_torch import (  # noqa: F401  (autouse fixture)
    assert_same_trees,
    one_torch_thread,
    run_in,
    run_printed,
)

MODULES = (("jax", jax_download), ("port", port_download))
PACKAGES = (("jax", jax_cli_main), ("port", port_cli_main))


def _write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(path, mode) as f:
        f.write(data)


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """The miniature NCBI tree of ``tests/test_download.py``, served on
    127.0.0.1 for the module: (base URL, its directory)."""
    root = tmp_path_factory.mktemp("ncbi_torch")
    asm = [
        ("GCF_000000001.1_ASM1v1", "Escherichia coli", "Complete Genome",
         "ACGT" * 300),
        ("GCF_000000002.1_ASM2v1", "Bacillus subtilis", "Chromosome",
         "TTGCA" * 200),
        ("GCF_000000003.1_ASM3v1", "Draftus fragmentus", "Scaffold",
         "GGCC" * 100),
    ]
    header = (
        "#   See assembly_summary_readme\n"
        "# assembly_accession\tbioproject\torganism_name\tassembly_level\t"
        "ftp_path\n"
    )
    rows = []
    for acc_dir, org, level, seq in asm:
        acc = acc_dir.split("_ASM")[0]
        ftp_path = (
            "https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/000/000/00X/"
            + acc_dir
        )
        rows.append(f"{acc}\tPRJ1\t{org}\t{level}\t{ftp_path}")
        d = root / "genomes" / "all" / "GCF" / "000" / "000" / "00X" / acc_dir
        _write(
            str(d / f"{acc_dir}_genomic.fna.gz"),
            gzip.compress(f">{acc}_contig1\n{seq}\n".encode(), mtime=0),
        )
        _write(
            str(d / f"{acc_dir}_assembly_report.txt"),
            f"# Assembly name: {acc_dir}\n# Taxid: 562\n",
        )
    _write(
        str(root / "genomes" / "refseq" / "bacteria" / "assembly_summary.txt"),
        header + "\n".join(rows) + "\n",
    )
    taxdir = root / "taxsrc"
    for fn in jax_download.TAXONOMY_FILES:
        _write(str(taxdir / fn), f"1\t|\t{fn}\t|\n")
    tgz = root / "pub" / "taxonomy" / "taxdump.tar.gz"
    os.makedirs(os.path.dirname(str(tgz)), exist_ok=True)
    with tarfile.open(str(tgz), "w:gz") as tf:
        for fn in jax_download.TAXONOMY_FILES:
            tf.add(str(taxdir / fn), arcname=fn)

    handler = lambda *a, **k: http.server.SimpleHTTPRequestHandler(  # noqa
        *a, directory=str(root), **k
    )
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", str(root)
    srv.shutdown()
    srv.server_close()


#: case -> the fetch's keywords, with "base" standing for the mirror's URL
FETCH_CASES = {
    "full_with_taxonomy": dict(taxonomy_dir="tax"),
    "missing_files": dict(include_suffixes=("_genomic.fna.gz",
                                            "_genomic.gff.gz")),
    "every_level": dict(assembly_levels=None),
    "max_assemblies": dict(max_assemblies=1),
    "complete_only": dict(assembly_levels=("Complete Genome",)),
}


def fetch_in(d, module, base_url, **kw):
    """``fetch`` of the bacteria branch into ``seq`` under ``d``: the
    result as a dict."""
    def run(_argv):
        plan = module.make_plan("seq", branches=["bacteria"],
                                base_url=base_url)
        return dataclasses.asdict(module.fetch(plan, timeout=10, **kw))

    return run_in(d, run, None)


@pytest.mark.parametrize("case", list(FETCH_CASES))
def test_fetch_matches_jax(mirror, tmp_path, case):
    base, _ = mirror
    results = {pkg: fetch_in(str(tmp_path / pkg), module, base,
                             **FETCH_CASES[case])
               for pkg, module in MODULES}
    assert results["port"] == results["jax"]
    got = results["port"]
    want = {"full_with_taxonomy": (2, 0), "missing_files": (0, 2),
            "every_level": (3, 0), "max_assemblies": (1, 0),
            "complete_only": (1, 0)}[case]
    assert (got["assemblies_downloaded"], len(got["failures"])) == want
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_resumed_fetch_matches_jax(mirror, tmp_path):
    """Three fetches into one target: everything, then nothing (all kept),
    then the one file truncated in between."""
    base, _ = mirror
    results = {}
    for pkg, module in MODULES:
        d = str(tmp_path / pkg)
        runs = [fetch_in(d, module, base), fetch_in(d, module, base)]
        fna = os.path.join(d, "seq", "bacteria", "Escherichia_coli",
                           "GCF_000000001.1_ASM1v1",
                           "GCF_000000001.1_ASM1v1_genomic.fna.gz")
        with open(fna, "rb") as f:
            full = f.read()
        with open(fna, "wb") as f:
            f.write(full[: len(full) // 2])
        runs.append(fetch_in(d, module, base))
        with open(fna, "rb") as f:
            assert f.read() == full
        results[pkg] = runs
    assert results["port"] == results["jax"]
    assert [(r["assemblies_downloaded"], r["assemblies_skipped"],
             r["files_downloaded"]) for r in results["port"]] == [
        (2, 0, 4), (0, 2, 0), (1, 1, 1)]
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_unreachable_summary_matches_jax(tmp_path):
    """A mirror on a closed local port: the summary fails, is reported,
    and nothing else is fetched."""
    results = {pkg: fetch_in(str(tmp_path / pkg), module,
                             "http://127.0.0.1:1")
               for pkg, module in MODULES}
    assert results["port"] == results["jax"]
    assert len(results["port"]["failures"]) == 1
    assert "assembly_summary" in results["port"]["failures"][0]
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))


#: case -> the CLI's argv after "downloadRefSeq", "base" standing for the
#: mirror's URL
CLI_CASES = {
    "manifest": ["--targetDir", "dl"],
    "manifest_genbank": ["--targetDir", "dl/", "--branches", "bacteria,viral",
                         "--DB", "genbank", "--baseUrl", "base"],
    "fetch_complete_only": ["--targetDir", "seq", "--branches", "bacteria",
                            "--fetch", "--taxonomyDir", "tax", "--baseUrl",
                            "base", "--skipIncompleteGenomes"],
    "fetch_max_assemblies": ["--targetDir", "seq", "--branches", "bacteria",
                             "--fetch", "--baseUrl", "base",
                             "--maxAssemblies", "1"],
    "fetch_two_branches": ["--targetDir", "seq", "--branches",
                           "bacteria,viral", "--fetch", "--baseUrl", "base"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax(mirror, tmp_path, case):
    """The same exit code, stdout (with the fetch's progress line) and
    files. The viral branch has no summary on the mirror: a failure, and
    exit code 1."""
    base, _ = mirror
    argv = ["downloadRefSeq"] + [base if a == "base" else a
                                 for a in CLI_CASES[case]]
    printed = {pkg: run_printed(str(tmp_path / pkg), main, argv)
               for pkg, main in PACKAGES}
    assert printed["port"] == printed["jax"]
    assert printed["port"][0] == (1 if case == "fetch_two_branches" else 0)
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    if case == "manifest":  # the default mirror, written and not fetched
        with open(str(tmp_path / "port" / "dl.manifest")) as f:
            assert f.readline() == (port_download.NCBI_FTP
                                    + "/pub/taxonomy/taxdump.tar.gz\n")


def test_parse_assembly_summary_matches_jax(mirror, tmp_path):
    """The mirror's summary, a summary with a ragged row and rows before
    any header, and an empty file."""
    _, root = mirror
    with open(os.path.join(root, "genomes", "refseq", "bacteria",
                           "assembly_summary.txt")) as f:
        summary = f.read()
    ragged = ("GCF_9\tPRJ\torphan row before the header\n" + summary
              + "GCF_8\tPRJ2\tToo short\n\nGCF_7\tPRJ3\tLast one\tScaffold\t"
              "na\n")
    paths = []
    for name, text in (("summary", summary), ("ragged", ragged),
                       ("empty", "")):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            f.write(text)
    for path in paths:
        want = jax_download.parse_assembly_summary(path)
        assert port_download.parse_assembly_summary(path) == want
    assert len(port_download.parse_assembly_summary(paths[0])) == 3
    assert len(port_download.parse_assembly_summary(paths[1])) == 4
    assert port_download.parse_assembly_summary(paths[2]) == []


def test_plan_and_manifest_match_jax(tmp_path):
    """``make_plan`` with the defaults and with a section and mirror, and
    the manifest each writes."""
    for kw in ({}, dict(branches=["fungi"], section="genbank",
                        base_url="http://127.0.0.1:8")):
        plans = {pkg: dataclasses.asdict(module.make_plan("t", **kw))
                 for pkg, module in MODULES}
        assert plans["port"] == plans["jax"]
    for pkg, module in MODULES:
        module.write_manifest(module.make_plan("t"), str(tmp_path / pkg))
    with open(str(tmp_path / "jax"), "rb") as a, \
            open(str(tmp_path / "port"), "rb") as b:
        want = a.read()
        assert want and b.read() == want
    assert port_download.NCBI_FTP == jax_download.NCBI_FTP
    assert port_download.DEFAULT_BRANCHES == jax_download.DEFAULT_BRANCHES
