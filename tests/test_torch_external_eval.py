"""The port's ``evaluateExternal`` (``sim/external_eval.py`` and the paper
figure set of ``tools/paper_plots.py``) against the JAX package's, on the
fixture of ``tests/test_external_eval.py`` (three species, seven truth
reads, one of them from a species outside the database, a perfect and a
flawed method, a WIMP-shaped distribution): through both CLIs with one and
with two ``--method``s, with a distribution-only method, with ``--fastq``
and with ``--plots``; ``evaluate_external`` itself; and
``parse_method_spec`` on the JAX tests' specs. Each package runs in its
own directory on the same relative paths; every file it writes and every
line it prints must be the other's, byte for byte (the PDFs made with
``SOURCE_DATE_EPOCH=0``, so they carry no creation time)."""
import json
import os

import numpy as np
import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.sim import external_eval as jax_external_eval
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.sim import external_eval as port_external_eval

from util_db import make_mini_db
from util_torch import (  # noqa: F401  (autouse fixture)
    assert_same_trees,
    one_torch_thread,
    run_in,
    run_printed,
)

PACKAGES = (("jax", jax_cli_main), ("port", port_cli_main))
EVAL = ["evaluateExternal", "--DB", "DB", "--truth", "truth.perRead"]
#: case -> the argv after EVAL
CASES = {
    "one_method": ["--method", "good=good.reads2Taxon:good.WIMP",
                   "--output", "eval"],
    "two_methods": ["--method", "good=good.reads2Taxon:good.WIMP",
                    "--method", "bad=bad.reads2Taxon", "--output", "eval"],
    "fastq_and_distribution_only": [
        "--fastq", "reads.fastq", "--method",
        "good=good.reads2Taxon:good.WIMP", "--method", "distonly=:good.WIMP",
        "--output", "clieval"],
    "plots": ["--fastq", "reads.fastq", "--method",
              "MetaMaps=good.reads2Taxon:good.WIMP", "--method",
              "Kraken2=bad.reads2Taxon:good.WIMP", "--output", "ploteval",
              "--plots"],
    "plots_genus_without_fastq": [
        "--method", "MetaMaps=good.reads2Taxon:good.WIMP", "--method",
        "bad=bad.reads2Taxon", "--output", "genuseval", "--plots",
        "--plotLevel", "genus"],
}
#: the figures each case draws
N_PDFS = {"plots": 6, "plots_genus_without_fastq": 2}
#: the specs of tests/test_external_eval.py::test_parse_method_spec, and
#: more of the same shapes
SPECS = ["MetaMaps=a.r2t:b.WIMP", "Bracken=:b.WIMP", "nopaths", "K=a.r2t",
         "=a.r2t", "M=a.r2t:", "M=a:b:c"]


def write_inputs(d):
    """``tests/test_external_eval.py``'s fixture under ``d``, by relative
    names."""
    db = os.path.join(d, "DB")
    rng = np.random.default_rng(7)
    _, _, species_ids = make_mini_db(db, rng, n_genomes=3, genome_len=20000)
    with open(os.path.join(d, "truth.perRead"), "w") as f:
        for i in range(6):
            f.write(f"r{i}\t{species_ids[i % 3]}\n")
        f.write("r6\t999\n")
    with open(os.path.join(db, "taxonomy", "nodes.dmp"), "a") as f:
        f.write("999\t|\t100\t|\tspecies\t|\n")
    with open(os.path.join(db, "taxonomy", "names.dmp"), "a") as f:
        f.write("999\t|\tNovelus\t|\t\t|\tscientific name\t|\n")
    with open(os.path.join(d, "good.reads2Taxon"), "w") as f:
        for i in range(6):
            f.write(f"r{i}\t{species_ids[i % 3]}\n")
        f.write(f"r6\t{species_ids[0]}\n")
    with open(os.path.join(d, "bad.reads2Taxon"), "w") as f:
        for i in range(7):
            f.write(f"r{i}\t{species_ids[0]}\n")
    with open(os.path.join(d, "good.WIMP"), "w") as f:
        f.write("AnalysisLevel\ttaxonID\tName\tAbsolute\tEMFrequency\t"
                "PotFrequency\n")
        for sid in species_ids:
            n = 2 + (1 if sid == species_ids[0] else 0)
            f.write(f"species\t{sid}\tSpecies\t{n}\t{n / 7}\t{n / 7}\n")
    with open(os.path.join(d, "reads.fastq"), "w") as f:
        for i in range(7):
            f.write(f"@r{i}\n" + "ACGT" * 600 + "\n+\n" + "I" * 2400 + "\n")


@pytest.fixture(autouse=True)
def no_pdf_dates(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_external_cli_matches_jax(tmp_path, case):
    printed = {}
    for pkg, main in PACKAGES:
        d = str(tmp_path / pkg)
        write_inputs(d)
        printed[pkg] = run_printed(d, main, EVAL + CASES[case])
    assert printed["port"] == printed["jax"]
    rc, out = printed["port"]
    assert rc == 0 and out.startswith("7 truth reads (1 projected")
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    pdfs = [n for n in os.listdir(str(tmp_path / "port"))
            if n.endswith(".pdf")]
    # the WIMP has species rows only: at genus no composition figures
    assert len(pdfs) == N_PDFS.get(case, 0), pdfs


def test_evaluate_external_returns_the_jax_result(tmp_path):
    """The library call with a good method (both files) and a bad one
    (reads only), ``--fastq`` and an output prefix: the same result
    dictionary and the same tables."""
    results = {}
    for pkg, module in (("jax", jax_external_eval),
                        ("port", port_external_eval)):
        d = str(tmp_path / pkg)
        write_inputs(d)
        methods = {
            "good": module.MethodFiles("good.reads2Taxon", "good.WIMP"),
            "bad": module.MethodFiles("bad.reads2Taxon", None),
        }
        res = run_in(d, lambda argv: module.evaluate_external(
            "DB", "truth.perRead", methods, fastq="reads.fastq",
            out_prefix="eval"), None)
        results[pkg] = json.dumps(res, sort_keys=True)
    assert results["port"] == results["jax"]
    got = json.loads(results["port"])
    assert got["meta"] == {"n_truth_reads": 7,
                           "n_truth_taxa_changed_by_projection": 1,
                           "n_reads_below_minlen": 0}
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_method_spec_matches_jax(spec):
    def parse(module):
        try:
            name, mf = module.parse_method_spec(spec)
        except ValueError as e:
            return "ValueError", str(e)
        return name, mf.reads2taxon, mf.distribution

    assert parse(port_external_eval) == parse(jax_external_eval)
