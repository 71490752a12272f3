"""The port's analysis and export tools against the JAX package's, through
both CLIs on the gene-level fixture of ``tests/test_tools.py`` (two 30 kb
genomes, a gene every 5 kb of the first, 24 reads): the chain
``mapDirectly`` -> ``classify`` -> ``geneLevelAnalysis`` -> ``filterWIMP``
(the JAX package with its serial oracle engine and host EM, the port with
its torch engine and EM rounds on the CPU), then on copies of its outputs
``geneLevelAnalysis`` (with both protein table layouts), ``filterWIMP`` at
0.8 and 0.999, ``convertDB`` to all three targets, ``plotIdentities``,
``splitEggNog`` split / submit / collect (with and without
``--targetChars`` and ``--cmd``), the three competitor database builders
(without their binaries, and with stand-ins that log their arguments),
``plot_validation_results`` and ``plot_unknown_results``. Each package runs
in its own directory on the same relative paths; every file it writes and
every line it prints must be the other's, byte for byte. The PDFs are made
with ``SOURCE_DATE_EPOCH=0``, so they carry no creation time."""
import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.tools import competitors as jax_competitors
from metamaps_tpu.tools import plots as jax_plots
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.tools import competitors as port_competitors
from metamaps_tpu_torch.tools import plots as port_plots

from util_db import make_mini_db, write_reads_fastq
from util_sim import sample_reads
from util_torch import (  # noqa: F401  (autouse fixture)
    assert_same_trees,
    one_torch_thread,
    run_in,
    run_printed,
    write_gene_annotations,
)

PACKAGES = (("jax", jax_cli_main), ("port", port_cli_main))
#: the chain: step name -> argv in each package's directory
CHAIN = {
    "mapDirectly": ["mapDirectly", "--reference", "DB/DB.fa", "--query",
                    "reads.fastq", "--output", "out", "--all",
                    "--minReadLen", "2000"],
    "classify": ["classify", "--DB", "DB", "--mappings", "out"],
    "geneLevelAnalysis": ["geneLevelAnalysis", "--DB", "DB", "--mappings",
                          "out"],
    "filterWIMP": ["filterWIMP", "--DB", "DB", "--mappings", "out"],
}
#: the chain's own engine and EM options, per package
CHAIN_OPTIONS = {
    "jax": {"mapDirectly": ["--mapping-engine", "oracle"]},
    "port": {"mapDirectly": ["--mapping-engine", "torch", "--device", "cpu"],
             "classify": ["--device", "cpu"]},
}
#: one subcommand on a copy of the chain's outputs
TOOL_CASES = {
    "geneLevelAnalysis": ["geneLevelAnalysis", "--DB", "DB", "--mappings",
                          "out"],
    "geneLevelAnalysis_emapper_table": ["geneLevelAnalysis", "--DB", "DB",
                                        "--mappings", "out"],
    "filterWIMP_0.8": ["filterWIMP", "--DB", "DB", "--mappings", "out",
                       "--identityThreshold", "0.8"],
    "filterWIMP_0.999": ["filterWIMP", "--DB", "DB", "--mappings", "out",
                         "--identityThreshold", "0.999"],
    "convertDB_kraken": ["convertDB", "--DB", "DB", "--to", "kraken",
                         "--output", "kr"],
    "convertDB_centrifuge": ["convertDB", "--DB", "DB", "--to",
                             "centrifuge", "--output", "cf"],
    "convertDB_mash": ["convertDB", "--DB", "DB", "--to", "mash",
                       "--output", "ms"],
    "plotIdentities": ["plotIdentities", "--mappings", "out"],
    "plotIdentities_output": ["plotIdentities", "--mappings", "out",
                              "--output", "panels.pdf"],
}
LL_RTOL = 1e-12  # an EM round's log-likelihood (tests/test_torch_em.py)
BUILDERS = ("build_kraken2_db", "build_centrifuge_index", "build_kraken1_db")
#: the competitor binaries the builders call
BUILD_BINARIES = ("kraken2-build", "centrifuge-build", "kraken-build")
#: an emapper stand-in: writes a chunk's annotation table (three comment
#: lines, the header, one row per protein)
FAKE_EMAPPER = """import sys
inp, out = sys.argv[1], sys.argv[2]
with open(out + ".emapper.annotations", "w") as o:
    o.write("# c1\\n# c2\\n# c3\\n")
    o.write("#query_name\\tGO_terms\\tKEGG_KOs\\tBiGG_reactions\\tOGs\\tCOG cat\\n")
    for line in open(inp):
        if line.startswith(">"):
            pid = line[1:].split()[0]
            n = int(pid.split("_")[1].split(".")[0])
            o.write(f"{pid}\\tGO:{n % 4}, GO:{n % 4},GO:9\\tK{n}\\t\\tOG{n % 2}\\t"
                    f"{'JKL'[n % 3]}\\n")
"""


@pytest.fixture(autouse=True)
def no_pdf_dates(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The gene-level fixture under ``base/``, then the chain in a copy of
    it per package: {package: (directory, {step: stdout})}."""
    root = tmp_path_factory.mktemp("torch_tools")
    base = str(root / "base")
    rng = np.random.default_rng(909)
    genomes, contig_names, _ = make_mini_db(os.path.join(base, "DB"), rng,
                                            n_genomes=2, genome_len=30000)
    write_gene_annotations(os.path.join(base, "DB"), contig_names[0], 30000)
    reads = sample_reads(rng, genomes, 24, min_len=2500, max_len=5000,
                         sub=0.05)
    write_reads_fastq(os.path.join(base, "reads.fastq"), reads)
    runs = {}
    for pkg, main in PACKAGES:
        d = str(root / pkg)
        shutil.copytree(base, d)
        printed = {}
        for step, argv in CHAIN.items():
            rc, printed[step] = run_printed(
                d, main, argv + CHAIN_OPTIONS[pkg].get(step, []))
            assert rc == 0, (pkg, step)
        runs[pkg] = d, printed
    return runs


@pytest.mark.parametrize("step", list(CHAIN))
def test_chain_prints_the_same(chains, step):
    """The same stdout at every step. classify prints each EM round's
    log-likelihood, whose last bits follow the round's summation order
    (the port's torch round, the JAX package's numpy round): there every
    word is the same and every number within ``LL_RTOL`` relative, as
    ``tests/test_torch_em.py`` holds the rounds."""
    want, got = chains["jax"][1][step], chains["port"][1][step]
    if step != "classify":
        assert got == want
        return
    assert want and len(got.split()) == len(want.split())
    for a, b in zip(got.split(), want.split()):
        try:
            x, y = float(a), float(b)
        except ValueError:
            assert a == b
            continue
        assert abs(x - y) <= LL_RTOL * abs(y), (a, b)


def test_chain_writes_the_same(chains):
    """mapDirectly -> classify -> geneLevelAnalysis -> filterWIMP: every
    file of the two directories (the mappings, .meta, the seven .EM*
    files, the gene-level tables and the filtered WIMP and reads2Taxon)."""
    assert_same_trees(chains["jax"][0], chains["port"][0])
    d = chains["port"][0]
    with open(os.path.join(d, "out.EM.geneLevelAnalysis")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    assert rows and all(int(r[4]) >= 1 and 0 <= float(r[5]) <= 1
                        for r in rows)
    assert os.path.exists(os.path.join(d, "out.EM.proteins.eggNOG"))


def write_emapper_table(db):
    """DB_proteins.faa.annotated as ``splitEggNog collect`` writes it."""
    with open(os.path.join(db, "DB_proteins.faa.annotated"), "w") as f:
        f.write("ProteinID\tGO_terms\tKEGG_KOs\tBiGG_reactions\tOGs\t"
                "COG_cat\n")
        for g in range(6):
            f.write(f"WP_{g}\tGO:{g % 2}, GO:{g % 2},GO:7\tK{g}\t\t"
                    f"OG{g % 3}\t{'JK'[g % 2]}\n")


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_matches_jax(chains, tmp_path, case):
    """One subcommand in a copy of each package's chain directory: the same
    exit code, stdout and files."""
    results = {}
    for pkg, main in PACKAGES:
        d = str(tmp_path / pkg)
        shutil.copytree(chains[pkg][0], d)
        if case == "geneLevelAnalysis_emapper_table":
            write_emapper_table(os.path.join(d, "DB"))
        results[pkg] = run_printed(d, main, TOOL_CASES[case])
    assert results["port"] == results["jax"]
    assert results["port"][0] == 0
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    d = str(tmp_path / "port")
    if case == "filterWIMP_0.999":  # every read unclassified
        with open(os.path.join(d, "out.EM.reads2Taxon.filteredByIdentity")) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        assert rows and all(r[1] == "0" for r in rows)
    if case == "convertDB_kraken":
        with open(os.path.join(d, "kr", "library", "metamaps.fna")) as f:
            heads = [line for line in f if line.startswith(">")]
        assert len(heads) == 2 and all("kraken:taxid|" in h for h in heads)
    if case == "convertDB_mash":
        assert len(os.listdir(os.path.join(d, "ms"))) == 2


def write_proteins(path, seed: int, n: int = 9):
    """A protein FASTA with wrapped records of 20-90 residues and a blank
    line between some, made from ``seed``."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    with open(path, "w") as f:
        for i in range(n):
            seq = aa[rng.integers(0, 20, int(rng.integers(20, 91)))]
            s = "M" + seq.tobytes().decode()
            f.write(f">WP_{i}.1 protein {i}\n")
            for j in range(0, len(s), 60):
                f.write(s[j:j + 60] + "\n")
            if i % 4 == 3:
                f.write("\n")


@pytest.mark.parametrize("with_cmd", [False, True], ids=["default_cmd", "cmd"])
@pytest.mark.parametrize("target", [None, "150"],
                         ids=["default_target", "targetChars"])
def test_split_eggnog_matches_jax(tmp_path, target, with_cmd):
    """split -> submit -> the chunks annotated -> collect, in each package:
    the same stdout at each step and the same files. With ``--cmd`` the
    job scripts run the annotation stand-in; with the default command
    (emapper.py, absent here) the stand-in annotates each chunk directly."""
    printed = {}
    for pkg, main in PACKAGES:
        d = str(tmp_path / pkg)
        os.makedirs(d)
        write_proteins(os.path.join(d, "prot.faa"), 1234)
        with open(os.path.join(d, "fake_emapper.py"), "w") as f:
            f.write(FAKE_EMAPPER)
        split = ["splitEggNog", "--action", "split", "--input", "prot.faa",
                 "--output", "annot.txt"]
        submit = ["splitEggNog", "--action", "submit", "--input", "prot.faa",
                  "--output", "annot.txt"]
        if target:
            split += ["--targetChars", target]
        if with_cmd:
            submit += ["--cmd",
                       f"{sys.executable} fake_emapper.py {{input}} {{output}}"]
        steps = [run_printed(d, main, split), run_printed(d, main, submit)]
        chunks = sorted(n for n in os.listdir(d) if ".split.i." in n)
        for n in chunks:
            i = n.rsplit(".", 1)[1]
            if with_cmd:
                subprocess.run(["bash", f"annot.txt.split.submit.{i}"],
                               cwd=d, check=True)
            else:
                subprocess.run([sys.executable, "fake_emapper.py", n,
                                f"annot.txt.split.o.{i}"], cwd=d, check=True)
        steps.append(run_printed(d, main, [
            "splitEggNog", "--action", "collect", "--input", "prot.faa",
            "--output", "annot.txt"]))
        printed[pkg] = steps, len(chunks)
    assert printed["port"] == printed["jax"]
    steps, n_chunks = printed["port"]
    assert [rc for rc, _ in steps] == [0, 0, 0]
    assert n_chunks > 1 if target else n_chunks == 1
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    # the chunks hold the input's records, each cut on a record boundary
    d = str(tmp_path / "port")
    with open(os.path.join(d, "prot.faa")) as f:
        want = "".join(line for line in f if line.strip())
    got = ""
    for i in range(1, n_chunks + 1):
        with open(os.path.join(d, f"annot.txt.split.i.{i}")) as f:
            text = f.read()
        assert text.startswith(">")
        got += text
    assert got == want


def test_split_eggnog_refusals_match_jax(tmp_path):
    """submit and collect before a split, a second split, and collect with
    a chunk's table missing raise the same errors in both packages."""
    errors = {}
    for pkg, main in PACKAGES:
        d = str(tmp_path / pkg)
        os.makedirs(d)
        write_proteins(os.path.join(d, "prot.faa"), 99, n=4)
        got = []
        for action in ("submit", "collect", "split", "split", "collect"):
            argv = ["splitEggNog", "--action", action, "--input", "prot.faa",
                    "--output", "annot.txt", "--targetChars", "100"]
            try:
                got.append(run_printed(d, main, argv))
            except RuntimeError as e:
                got.append(("raised", str(e)))
        errors[pkg] = got
    assert errors["port"] == errors["jax"]
    assert [g[0] for g in errors["port"]] == ["raised", "raised", 0,
                                              "raised", "raised"]


def fake_binaries(bin_dir) -> None:
    """Stand-ins for the competitors' build binaries: each appends its name
    and arguments to calls.log in the working directory."""
    os.makedirs(bin_dir)
    for name in BUILD_BINARIES:
        path = os.path.join(bin_dir, name)
        with open(path, "w") as f:
            f.write('#!/bin/sh\necho "${0##*/} $*" >> calls.log\n')
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)


@pytest.mark.parametrize("builder", BUILDERS)
def test_builder_without_binary_raises_the_ports_error(chains, tmp_path,
                                                       monkeypatch, builder):
    """Without its binary each builder raises the port's
    CompetitorNotInstalled (the JAX one raises its own), with the same
    message, and writes nothing."""
    empty = tmp_path / "empty_bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    messages = {}
    for pkg, module in (("jax", jax_competitors), ("port", port_competitors)):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        with pytest.raises(module.CompetitorNotInstalled) as e:
            run_in(d, lambda argv: getattr(module, builder)(*argv),
                   [os.path.join(chains[pkg][0], "DB"), "built"])
        assert type(e.value) is module.CompetitorNotInstalled
        messages[pkg] = str(e.value)
        assert os.listdir(d) == []
    assert messages["port"] == messages["jax"]
    assert port_competitors.CompetitorNotInstalled is not \
        jax_competitors.CompetitorNotInstalled


@pytest.mark.parametrize("builder", BUILDERS)
def test_builder_converts_and_calls_like_jax(chains, tmp_path, monkeypatch,
                                             builder):
    """With stand-in binaries each builder converts the database through
    its package's ``tools/convert.py`` and calls the binary with the same
    arguments: the same return value and the same files."""
    fake_binaries(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    returned = {}
    for pkg, module in (("jax", jax_competitors), ("port", port_competitors)):
        d = str(tmp_path / pkg)
        shutil.copytree(os.path.join(chains["jax"][0], "DB"),
                        os.path.join(d, "DB"))
        returned[pkg] = run_in(
            d, lambda argv: getattr(module, builder)(*argv), ["DB", "built"])
    assert returned["port"] == returned["jax"]
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    with open(os.path.join(str(tmp_path / "port"), "calls.log")) as f:
        assert len(f.read().splitlines()) == (
            1 if builder == "build_centrifuge_index" else 2)
    assert os.path.isdir(os.path.join(str(tmp_path / "port"), "built",
                                      "_converted"))


def test_plot_validation_results_matches_jax(chains, tmp_path):
    """The simulation-accuracy panels of one evaluation (the chain's
    reads2Taxon as the truth), drawn by each package: the same PDF."""
    from metamaps_tpu_torch.sim.validation import evaluate_experiment

    d = chains["port"][0]
    res = evaluate_experiment(os.path.join(d, "DB"),
                              os.path.join(d, "out.EM.reads2Taxon"),
                              os.path.join(d, "out"))
    pdfs = {}
    for pkg, module in (("jax", jax_plots), ("port", port_plots)):
        pdfs[pkg] = module.plot_validation_results(
            res, str(tmp_path / f"{pkg}.pdf"), title="chain")
    with open(pdfs["jax"], "rb") as a, open(pdfs["port"], "rb") as b:
        want = a.read()
        assert want.startswith(b"%PDF") and b.read() == want


def test_plot_unknown_results_matches_jax(tmp_path):
    """Shifted identity histograms of a .U.shiftedHistogramsPerTaxonID made
    from a seed, drawn by each package at the default path: the same PDF."""
    rng = np.random.default_rng(31)
    rows = "taxonID\tkind\tidentity\tp\n" + "".join(
        f"{taxon}\t{kind}\t{identity}\t{rng.random():.6f}\n"
        for taxon in ("100", "101", "x3") for kind in ("observed", "expected")
        for identity in range(80, 100, 2))
    for pkg, module in (("jax", jax_plots), ("port", port_plots)):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        with open(os.path.join(d, "out.U.shiftedHistogramsPerTaxonID"),
                  "w") as f:
            f.write(rows)
        assert run_in(d, lambda argv: module.plot_unknown_results(*argv),
                      ["out"]) == "out.U.shiftedHistograms.pdf"
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
