"""The port's simulation, truth and read tools against the JAX package's,
through both CLIs on the fixture of ``tests/test_simulation.py`` (three
50 kb genomes): ``simulate`` in its four actions (``inference`` with the
JAX package's serial oracle and host EM, and with the port's torch engine
and EM rounds on the CPU), ``buildTruth``, ``truthDataset`` (CAMI, Zymo
and HMP on the fixture files of ``tests/test_competitors_truth.py``),
``extractReads``, ``firstQuartileScore``, ``compareMappings`` and
``benchmarkInference``. Each package runs in its own directory with the
same relative paths; every file it writes, and every line it prints, must
be the other's. Then the competitor parsers of ``tools/competitors.py`` on
the same files, and ``CompetitorNotInstalled`` for a missing binary."""
import contextlib
import io
import os

import numpy as np
import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.taxonomy import Taxonomy as JaxTaxonomy
from metamaps_tpu.tools import competitors as jax_competitors
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.taxonomy import Taxonomy
from metamaps_tpu_torch.tools import competitors

from util_db import make_mini_db
from util_torch import one_torch_thread, run_in, tree_bytes  # noqa: F401  (autouse fixture)

SAM_HEADER = "@HD\tVN:1.0\n"
#: input files written into each package's directory
INPUTS = {
    "t.fastq": "@NC_0001.1_read1\nACGT\n+\nIIII\n@NC_0002.1_read7\nGGCC\n+\n"
               "IIII\n@unknownacc_read2\nTTAA\n+\nIIII\n",
    "acc.tsv": "NC_0001.1\t1000\nNC_0002.1\t7777777\n",
    "r.fastq": "@r1\nACGT\n+\nII#I\n@r2\nGGCC\n+\n!!II\n@r3\nTTAA\n+\nJJJJ\n"
               "@rX\nACGTACGT\n+\n++++++++\n",
    "ids.txt": "r1\nr3\n",
    "r.r2t": "r1\t1000\nr2\t0\nr3\t1001\n",
    "reads_mapping.tsv": "#anonymous_read_id\tgenome_id\ttax_id\tread_id\n"
                         "ar0\tG1\t1000\torig0\nar1\tG1\t1000\torig1\n"
                         "ar2\tG2\t1001\torig2\n",
    "zymo.fa": ">tx1000|chrA\nACGTACGT\n>tx1001|chrB\nACGTACGT\n",
    "zymo.sam": SAM_HEADER
    + "r1\t0\ttx1000|chrA\t1\t60\t8M\t*\t0\t0\tACGTACGT\t*\n"
    + "r1\t256\ttx1001|chrB\t1\t60\t8M\t*\t0\t0\tACGTACGT\t*\n"
    + "r2\t0\ttx1001|chrB\t1\t30\t8M\t*\t0\t0\tACGTACGT\t*\n"
    + "r3\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n",
    "gi2taxon.tsv": "4711\t1000\n4712\t1001\n",
    "hmp.sam": SAM_HEADER
    + "r1\t0\tgi|4711|ref|NC_1|\t1\t60\t4M\t*\t0\t0\tACGT\t*\n"
    + "r2\t0\tgi|4712|ref|NC_2|\t1\t20\t4M\t*\t0\t0\tACGT\t*\n"
    + "r2\t0\tgi|4711|ref|NC_1|\t1\t50\t4M\t*\t0\t0\tACGT\t*\n",
}
DB = ["--DB", "../DB"]
#: step name -> argv, run in order in each package's directory
STEPS = {
    "reads": ["simulate", "--action", "reads", *DB, "--out", "sim",
              "--nReads", "25", "--seed", "3"],
    "reads_abundant": ["simulate", "--action", "reads", *DB, "--out", "sim2",
                       "--nReads", "12", "--seed", "4", "--meanLength",
                       "3000", "--accuracy", "0.95"],
    "inference": ["simulate", "--action", "inference", *DB, "--out", "inf",
                  "--reads", "sim.fastq"],
    "evaluate": ["simulate", "--action", "evaluate", *DB, "--out", "inf",
                 "--truth", "sim.truth", "--mappings", "inf"],
    "reducedDB": ["simulate", "--action", "reducedDB", *DB, "--out", "red",
                  "--removeTaxa", "1002"],
    "buildTruth": ["buildTruth", "--reads", "t.fastq", "--accessions",
                   "acc.tsv", "--output", "truth.tsv"],
    "buildTruth_DB": ["buildTruth", "--reads", "t.fastq", "--accessions",
                      "acc.tsv", *DB, "--output", "truth_db.tsv"],
    "buildTruth_pattern": ["buildTruth", "--reads", "t.fastq", "--accessions",
                           "acc.tsv", "--pattern", r"^(NC_\d+\.\d)_",
                           "--output", "truth_pat.tsv"],
    "truth_cami": ["truthDataset", "--dataset", "cami", "--mapping",
                   "reads_mapping.tsv", *DB, "--output", "cami"],
    "truth_zymo": ["truthDataset", "--dataset", "zymo", "--reference",
                   "zymo.fa", "--alignments", "zymo.sam", "--reads",
                   "r.fastq", *DB, "--output", "zymo"],
    "truth_hmp": ["truthDataset", "--dataset", "hmp", "--alignments",
                  "hmp.sam", "--gi2taxon", "gi2taxon.tsv", "--reads",
                  "r.fastq", "--output", "hmp"],
    "extract_ids": ["extractReads", "--reads", "r.fastq", "--ids", "ids.txt",
                    "--output", "sub.fastq"],
    "extract_taxon": ["extractReads", "--reads", "r.fastq", "--r2t", "r.r2t",
                      *DB, "--target", "1000", "--output", "sub2.fastq"],
    "extract_sorted": ["extractReads", "--reads", "sim.fastq", "--ids",
                       "ids_sim.txt", "--mode", "sortedFasta", "--output",
                       "sub.fa"],
    "extract_lengths": ["extractReads", "--reads", "sim.fastq", "--ids",
                        "ids_sim.txt", "--mode", "lengthDistribution",
                        "--output", "sub.len"],
    "firstQuartileScore": ["firstQuartileScore", "--fastq", "r.fastq"],
    "compareMappings": ["compareMappings", "inf", "inf_edit"],
    "compareMappings_tol": ["compareMappings", "inf", "inf_edit",
                            "--posTolerance", "5"],
    "benchmarkInference": ["benchmarkInference", "--mappings", "inf",
                           "--truth", "sim.truth"],
}
#: steps that must return 1 (a missing argument), in both packages
REFUSED = {
    "reducedDB_no_taxa": ["simulate", "--action", "reducedDB", *DB, "--out",
                          "red2"],
    "extract_no_ids": ["extractReads", "--reads", "r.fastq", "--output",
                       "sub3.fastq"],
}
OUTPUTS = ("sim.fastq", "sim.truth", "sim2.fastq", "sim2.truth", "inf",
           "inf.meta", "inf.EM", "inf.EM.WIMP", "inf.EM.reads2Taxon",
           "truth.tsv", "truth_db.tsv", "truth_pat.tsv", "cami.perRead",
           "cami.distribution", "cami.genomesOfOrigin", "zymo.perRead",
           "zymo.distribution", "hmp.perRead", "sub.fastq", "sub2.fastq",
           "sub.fa", "sub.len")


def _edit_mappings(d):
    """inf_edit: inf with one read's first line moved by 3 bases and another
    read dropped (what compareMappings reports)."""
    with open(os.path.join(d, "inf")) as f:
        lines = f.read().splitlines()
    reads = list(dict.fromkeys(line.split(" ", 1)[0] for line in lines))
    out = []
    for line in lines:
        fields = line.split(" ")
        if fields[0] == reads[-1]:
            continue
        if fields[0] == reads[0] and not out:
            fields[7] = str(int(fields[7]) + 3)
        out.append(" ".join(fields))
    with open(os.path.join(d, "inf_edit"), "w") as f:
        f.write("\n".join(out) + "\n")
    with open(os.path.join(d, "sim.truth")) as f:
        ids = [line.split("\t")[0] for line in f][::3]
    with open(os.path.join(d, "ids_sim.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sim")
    make_mini_db(str(root / "DB"), np.random.default_rng(808), n_genomes=3,
                 genome_len=50000)
    runs = {}
    for pkg, main, extra in (("jax", jax_cli_main, {}),
                             ("port", port_cli_main,
                              {"inference": ["--device", "cpu"]})):
        d = str(root / pkg)
        os.makedirs(d)
        for name, text in INPUTS.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        printed = {}
        for step, argv in {**STEPS, **REFUSED}.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = run_in(d, main, argv + extra.get(step, []))
            assert rc == (1 if step in REFUSED else 0), (pkg, step)
            printed[step] = buf.getvalue()
            if step == "inference":
                _edit_mappings(d)
        runs[pkg] = d, printed
    return root, runs


@pytest.mark.parametrize("step", list(STEPS) + list(REFUSED))
def test_same_stdout(sims, step):
    _, runs = sims
    assert runs["port"][1][step] == runs["jax"][1][step]


@pytest.mark.parametrize("name", OUTPUTS)
def test_same_file_bytes(sims, name):
    _, runs = sims
    with open(os.path.join(runs["jax"][0], name), "rb") as a, \
            open(os.path.join(runs["port"][0], name), "rb") as b:
        want = a.read()
        assert want and b.read() == want


def test_reduced_db_bytes(sims):
    _, runs = sims
    want = tree_bytes(os.path.join(runs["jax"][0], "red"))
    assert "taxonInfo.txt" in want and b"1002" not in want["taxonInfo.txt"]
    assert tree_bytes(os.path.join(runs["port"][0], "red")) == want


def test_tools_report_what_they_read(sims):
    """The port's own outputs make sense, beyond equalling the JAX
    package's: the edited read counts as different, the evaluation found
    the reads, the extraction picked the reads asked for."""
    _, runs = sims
    d, printed = runs["port"]
    assert "different 1; only-A 1; only-B 0" in printed["compareMappings"]
    assert "different 0; only-A 1" in printed["compareMappings_tol"]
    assert '"ALL"' in printed["evaluate"]
    with open(os.path.join(d, "sub.fastq")) as f:
        assert f.read() == "@r1\nACGT\n+\nII#I\n@r3\nTTAA\n+\nJJJJ\n"
    assert printed["firstQuartileScore"] == "('+', 10)\n"


def _competitor_inputs(d):
    files = {
        "k.report": "  20.00\t2\t2\tU\t0\tunclassified\n"
                    "  80.00\t8\t0\tR\t1\troot\n"
                    "  50.00\t5\t5\tS\t1000\t    Species0\n"
                    "  30.00\t3\t3\tS\t1001\t    Species1\n",
        "k.reads": "".join([f"C\tr{i}\t1000\t5000\n" for i in range(5)]
                           + [f"C\tr{5 + i}\t1001\t5000\n" for i in range(3)]
                           + [f"U\tr{8 + i}\t0\t5000\n" for i in range(2)]),
        "b.report": "  10.00\t1\t1\tU\t0\tunclassified\n"
                    "  90.00\t9\t0\tR\t1\troot\n",
        "b.species": "name\ttaxonomy_id\ttaxonomy_lvl\tkraken_assigned_reads\t"
                     "added_reads\tnew_est_reads\tfraction_total_reads\n"
                     "Species0\t1000\tS\t4\t2\t6\t0.667\n"
                     "Species1\t1001\tS\t2\t0\t2\t0.222\n",
        "b.genus": "name\ttaxonomy_id\ttaxonomy_lvl\tkraken_assigned_reads\t"
                   "added_reads\tnew_est_reads\tfraction_total_reads\n"
                   "Genus0\t100\tG\t6\t2\t8\t0.889\n",
        "m.reads": "r0\t1000\nr1\t-2\nr2\t1001\n",
        "c.out": "readID\tseqID\ttaxID\tscore\nr1\tC5|x\t0\t10\n"
                 "r1\tC6|x\t99\t9\nr2\tunclassified\t0\t0\nr3\tC7|y\t1001\t4\n",
        "mp.profile": "#profile\n1000\tspecies\t.\t.\t55.5\n"
                      "1001\tspecies\t.\t.\t20\n100\tgenus\t.\t.\t60\n",
    }
    for name, text in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)


@pytest.mark.parametrize("parser", ["kraken_to_composition",
                                    "bracken_to_composition",
                                    "megan_reads_to_reads2taxon",
                                    "kraken_reads_to_reads2taxon",
                                    "centrifuge_reads_to_reads2taxon",
                                    "metapalette_to_composition"])
def test_competitor_parsers(sims, tmp_path, parser):
    root, _ = sims
    tax_dir = str(root / "DB" / "taxonomy")
    outs = {}
    for pkg, mod, tax in (("jax", jax_competitors, JaxTaxonomy(tax_dir)),
                          ("port", competitors, Taxonomy(tax_dir))):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        _competitor_inputs(d)
        out = os.path.join(d, "out")
        p = lambda name: os.path.join(d, name)  # noqa: E731
        fn = getattr(mod, parser)
        if parser == "kraken_to_composition":
            fn(p("k.report"), p("k.reads"), tax, {"1000", "1001", "1002"}, out)
        elif parser == "bracken_to_composition":
            fn(p("b.report"), {"species": p("b.species"),
                               "genus": p("b.genus")}, tax, out)
        elif parser == "megan_reads_to_reads2taxon":
            fn(p("m.reads"), out, all_read_ids={"r0", "r1", "r2", "r3"})
        elif parser == "kraken_reads_to_reads2taxon":
            fn(p("k.reads"), out)
        elif parser == "centrifuge_reads_to_reads2taxon":
            fn(p("c.out"), out, contig_to_taxon={"C5": "777"})
        else:
            fn(p("mp.profile"), tax, out)
        outs[pkg] = {name: v for name, v in tree_bytes(d).items()
                     if name.startswith("out")}
    assert outs["jax"] and outs["port"] == outs["jax"]


@pytest.mark.parametrize("call", ["run_kraken", "run_centrifuge",
                                  "run_kraken2_with_report"])
def test_missing_competitor_binary(tmp_path, monkeypatch, call):
    """A competitor whose binary is not on PATH raises
    CompetitorNotInstalled, with the JAX package's message: the one error
    ``experiments`` records as a skipped run."""
    monkeypatch.setenv("PATH", str(tmp_path))
    errors = []
    for mod in (jax_competitors, competitors):
        with pytest.raises(mod.CompetitorNotInstalled) as e:
            getattr(mod, call)("db", "reads", str(tmp_path / "out"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "not found on PATH" in errors[1]
    assert issubclass(competitors.CompetitorNotInstalled, RuntimeError)
