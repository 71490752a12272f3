"""The port's database tools against the JAX package's, through both CLIs
on the toolchain fixture of ``tests/test_db_tools.py`` (genus 50 with
species 500 and 501, three 40 kb genomes, two of them under 501, which
``annotate`` turns into x pseudo-nodes): ``annotate``, ``buildDB`` (plain,
``--shuffle``, ``--gff``, ``--proteins``, a source taxonomy with a
merged.dmp), ``validateDB``, ``DBinfo``, ``addTaxonIDToFasta``,
``shortenContigIDs``, ``selfSimilarity`` in ``all`` and in ``prepare`` ->
``runJob`` -> ``collect`` and ``prepareFromTemplate`` (at ``--simFrom 2000
--simTo 4000 --simStep 2000 --maxChunks 20``), then ``mapDirectly`` ->
``classify`` -> ``classifyU`` on the database that ``selfSimilarity``
completed. Each package runs in its own directory with the same relative
paths; every file it writes, and every line it prints, must be the
other's."""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.sim.truth import project_truth_into_db as jax_project
from metamaps_tpu.taxonomy import Taxonomy as JaxTaxonomy
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.sim.truth import project_truth_into_db
from metamaps_tpu_torch.taxonomy import Taxonomy

from util_db import write_reads_fastq
from util_sim import mutate, random_genome, sample_reads
from util_torch import one_torch_thread, run_in, tree_bytes  # noqa: F401  (autouse fixture)

SS_ARGS = ["--simFrom", "2000", "--simTo", "4000", "--simStep", "2000",
           "--maxChunks", "20"]
BUILD = ["--FASTAs", "annotated.fa", "--taxonomy", "tax_src"]
U_FILES = (".mapQ_U", ".U.WIMP", ".U.WIMP.absoluteClassifiedAt",
           ".U.reads2Taxon", ".U.lengthAndIdentitiesPerTaxonID",
           ".U.shiftedHistogramsPerTaxonID", ".EM2U.details",
           ".EM2U.summary")
#: step name -> argv, run in order in each package's directory
STEPS = {
    "annotate": ["annotate", "--genomes", "gA.fa=500,gB.fa=501,gB2.fa=501",
                 "--output", "annotated.fa", "--taxonomy", "tax_src"],
    "buildDB": ["buildDB", "--DB", "DB", *BUILD],
    "buildDB_shuffle": ["buildDB", "--DB", "DB_shuffle", *BUILD, "--shuffle"],
    "buildDB_gff": ["buildDB", "--DB", "DB_gff", *BUILD, "--gff", "a.gff"],
    "buildDB_proteins": ["buildDB", "--DB", "DB_proteins", *BUILD,
                         "--proteins", "p1.faa,p2.faa"],
    "buildDB_merged": ["buildDB", "--DB", "DB_merged", "--FASTAs",
                       "annotated.fa", "--taxonomy", "tax_merged"],
    "buildDB_steps": ["buildDB", "--DB", "DB_steps", *BUILD],
    "validateDB": ["validateDB", "--DB", "DB"],
    "DBinfo": ["DBinfo", "--DB", "DB"],
    "addTaxonIDToFasta": ["addTaxonIDToFasta", "--input", "gA.fa",
                          "--output", "gA.taxed.fa", "--taxonID", "562"],
    "shortenContigIDs": ["shortenContigIDs", "--input", "annotated.fa",
                         "--output", "short.fa", "--mapping", "short.map"],
    "selfSimilarity": ["selfSimilarity", "--DB", "DB", *SS_ARGS],
    "ss_prepare": ["selfSimilarity", "--DB", "DB_steps", "--mode", "prepare"],
    # one runJob per job: the jobs.json of the fixture holds five
    **{f"ss_runJob{i}": ["selfSimilarity", "--DB", "DB_steps", "--mode",
                         "runJob", "--jobI", str(i), *SS_ARGS]
       for i in range(5)},
    "ss_collect": ["selfSimilarity", "--DB", "DB_steps", "--mode",
                   "collect"],
    "reducedDB": ["simulate", "--action", "reducedDB", "--DB", "DB_steps",
                  "--out", "DB_reduced", "--removeTaxa", "x2"],
    "ss_template": ["selfSimilarity", "--DB", "DB_reduced", "--mode",
                    "prepareFromTemplate", "--templateDB", "DB_steps"],
}
#: steps the JAX package skips: its serial oracle takes 15 s for ``all``,
#: which the port's ``all`` is held against through its ``runJob`` steps
PORT_ONLY = ("selfSimilarity",)
SS_FILES = ("selfSimilarities.txt", "selfSimilarities.txt.expectedGenomeSizes")


def dmp_line(*fields):
    return "\t|\t".join(str(f) for f in fields) + "\t|\n"


def write_inputs(d):
    """The inputs of ``tests/test_db_tools.py``'s toolchain fixture, plus a
    GFF file, two protein FASTAs and reads of the three genomes, under
    ``d``."""
    tax_src = os.path.join(d, "tax_src")
    os.makedirs(tax_src)
    with open(os.path.join(tax_src, "names.dmp"), "w") as f:
        f.write(dmp_line(1, "all", "", "scientific name"))
        f.write(dmp_line(2, "Bacteria", "", "scientific name"))
        f.write(dmp_line(50, "GenusA", "", "scientific name"))
        f.write(dmp_line(500, "SpeciesA", "", "scientific name"))
        f.write(dmp_line(501, "SpeciesB", "", "scientific name"))
        f.write(dmp_line(99, "Unused", "", "scientific name"))
    with open(os.path.join(tax_src, "nodes.dmp"), "w") as f:
        f.write(dmp_line(1, 1, "no rank"))
        f.write(dmp_line(2, 1, "superkingdom"))
        f.write(dmp_line(50, 2, "genus"))
        f.write(dmp_line(500, 50, "species"))
        f.write(dmp_line(501, 50, "species"))
        f.write(dmp_line(99, 2, "genus"))

    rng = np.random.default_rng(5150)
    gA = random_genome(rng, 40000)
    gB = mutate(rng, gA, sub=0.10)
    gB2 = mutate(rng, gA, sub=0.10)
    for name, g in [("gA.fa", gA), ("gB.fa", gB), ("gB2.fa", gB2)]:
        with open(os.path.join(d, name), "w") as f:
            f.write(">" + name[:-3] + "_contig1 some description\n")
            f.write(g.tobytes().decode() + "\n")
    with open(os.path.join(d, "a.gff"), "w") as f:
        f.write("##gff-version 3\n")
        f.write("gA_contig1\t.\tgene\t100\t400\t.\t+\t.\t"
                "ID=g1;Name=dnaA;locus_tag=LT1\n")
        f.write("gA_contig1\t.\tCDS\t100\t400\t.\t+\t0\t"
                "ID=c1;Parent=g1;protein_id=WP_1;product=replication protein\n")
        f.write("gB_contig1\t.\tgene\t900\t1500\t.\t-\t.\tID=g2;Name=recA\n")
    with open(os.path.join(d, "p1.faa"), "w") as f:
        f.write(">WP_1.1 protA\nMKL\nAV\n>WP_2.1 protB\nMGG\n")
    with open(os.path.join(d, "p2.faa"), "w") as f:
        f.write(">WP_2.1 protB dup\nMGG\n>WP_3.1 protC\nMTT\n")
    reads = sample_reads(rng, [gA, gB, gB2], 30, min_len=2500, max_len=5000,
                         sub=0.04)
    write_reads_fastq(os.path.join(d, "reads.fastq"), reads)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Every step of ``STEPS`` (the JAX package: but ``PORT_ONLY``), then
    ``mapDirectly`` -> ``classify`` -> ``classifyU`` on DB_steps, in each
    package: {package: (directory, {step:
    stdout})}."""
    root = tmp_path_factory.mktemp("torch_db_tools")
    runs = {}
    for pkg, main, engine in (
            ("jax", jax_cli_main, ["--mapping-engine", "oracle"]),
            ("port", port_cli_main, ["--mapping-engine", "torch",
                                     "--device", "cpu"])):
        d = str(root / pkg)
        os.makedirs(d)
        write_inputs(d)
        printed = {}
        for step, argv in STEPS.items():
            if pkg == "jax" and step in PORT_ONLY:
                continue
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run_in(d, main, argv) == 0, (pkg, step)
            printed[step] = buf.getvalue()
            if step == "annotate":  # the annotated taxonomy with merged IDs
                tax_merged = os.path.join(d, "tax_merged")
                shutil.copytree(os.path.join(d, "tax_src"), tax_merged)
                with open(os.path.join(tax_merged, "merged.dmp"), "w") as f:
                    f.write("9999\t|\t8888\t|\n8888\t|\t500\t|\n"
                            "7777\t|\t12345\t|\n")
        device = engine[2:]
        for argv in (
                ["mapDirectly", "--reference", "DB_steps/DB.fa", "--query",
                 "reads.fastq", "--output", "out", "--all", "--minReadLen",
                 "2000", *engine],
                ["classify", "--DB", "DB_steps", "--mappings", "out",
                 "--minreads", "2", *device],
                ["classifyU", "--DB", "DB_steps", "--mappings", "out",
                 "--minreads", "2"]):
            assert run_in(d, main, argv) == 0, (pkg, argv[0])
        runs[pkg] = d, printed
    return runs


def test_jobs_of_the_fixture(chains):
    d, _ = chains["port"]
    with open(os.path.join(d, "DB_steps", "selfSimilarity", "jobs.json")) as f:
        assert len(json.load(f)) == 5  # the runJob steps of STEPS


@pytest.mark.parametrize("step", [s for s in STEPS if s not in PORT_ONLY])
def test_same_stdout(chains, step):
    assert chains["port"][1][step] == chains["jax"][1][step]


@pytest.mark.parametrize("name", [
    "DB", "DB_shuffle", "DB_gff", "DB_proteins", "DB_merged", "DB_steps",
    "DB_reduced", "tax_src"])
def test_same_directory_bytes(chains, name):
    want = tree_bytes(os.path.join(chains["jax"][0], name))
    got = tree_bytes(os.path.join(chains["port"][0], name))
    if name == "DB":  # the port's ``all`` run: test_self_similarity_*
        got = {k: v for k, v in got.items()
               if not k.startswith("selfSimilarit")}
    assert want and sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], path


@pytest.mark.parametrize("name", ["annotated.fa", "gA.taxed.fa", "short.fa",
                                  "short.map"])
def test_same_file_bytes(chains, name):
    with open(os.path.join(chains["jax"][0], name), "rb") as a, \
            open(os.path.join(chains["port"][0], name), "rb") as b:
        want = a.read()
        assert want and b.read() == want


@pytest.mark.parametrize("name", SS_FILES + ("selfSimilarity",))
def test_self_similarity_all_mode_is_the_jax_packages(chains, name):
    """The port's ``all`` on DB writes what the JAX package's ``prepare``
    -> ``runJob`` -> ``collect`` writes on DB_steps (DB's twin): the
    jobs, each job's results/<i>.json and .reads.json, and the files."""
    def read(path):
        if os.path.isdir(path):
            return tree_bytes(path)
        with open(path, "rb") as f:
            return f.read()

    want = read(os.path.join(chains["jax"][0], "DB_steps", name))
    got = read(os.path.join(chains["port"][0], "DB", name))
    assert want and got == want


def test_self_similarity_rows(chains):
    """The file has rows for the genus node and the x-nodes' parent, and
    each (node, length)'s probabilities sum to one."""
    d, _ = chains["port"]
    with open(os.path.join(d, "DB", "selfSimilarities.txt")) as f:
        rows = [line.split("\t") for line in f.read().splitlines()]
    assert {"50", "501"} <= {r[0] for r in rows}
    sums = {}
    for r in rows:
        sums[r[0], r[1]] = sums.get((r[0], r[1]), 0.0) + float(r[3])
    assert all(abs(v - 1.0) < 1e-6 for v in sums.values()), sums


@pytest.mark.parametrize("suffix", ("", ".EM.WIMP", ".EM.reads2Taxon")
                         + U_FILES)
def test_classify_u_on_the_self_similarities(chains, suffix):
    with open(os.path.join(chains["jax"][0], "out" + suffix)) as a, \
            open(os.path.join(chains["port"][0], "out" + suffix)) as b:
        want = a.read()
        assert want and b.read() == want, suffix


def test_merged_dmp_translation(chains):
    """The trimmed taxonomy keeps merged.dmp; outdated IDs follow its chain
    in the port's Taxonomy and truth projection as in the JAX package's."""
    d, _ = chains["port"]
    tax = os.path.join(d, "DB_merged", "taxonomy")
    port, jax = Taxonomy(tax), JaxTaxonomy(tax)
    for taxon in ("500", "9999", "x1", "0"):
        assert port.find_current_node_id(taxon) == \
            jax.find_current_node_id(taxon)
    assert port.find_current_node_id("9999") == "500"
    with pytest.raises(RuntimeError):
        port.find_current_node_id("7777")
    truth = {"r1": "9999", "r2": "501", "r3": "0"}
    assert project_truth_into_db(truth, port, {"500"}) == \
        jax_project(truth, jax, {"500"})
