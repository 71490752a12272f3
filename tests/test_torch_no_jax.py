"""The port stands alone: with ``jax``, ``jaxlib`` and the JAX package
``metamaps_tpu`` blocked on ``sys.meta_path``, every ``metamaps_tpu_torch``
module and ``chip_smoke.py`` import, and ``mapDirectly`` + ``classify``,
``mapDirectly --mesh`` + ``classify --emBackend sharded``, then ``index``
-> ``mapAgainstIndex`` -> ``classify`` -> ``classifyU``, run through the
port's CLI on a tiny database (torch engine and EM rounds on the CPU), with
``geneLevelAnalysis``, ``filterWIMP``, ``convertDB`` (all three targets),
``splitEggNog`` (split, submit, collect), ``evaluateExternal --plots``,
``plotIdentities`` and ``downloadRefSeq`` (its manifest) on the first
``classify``'s output; then ``synthDB`` -> ``experiments`` and
``annotate`` -> ``buildDB`` -> ``validateDB``."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "metamaps_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
        del sys.modules[mod]

    import numpy as np
    import metamaps_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        metamaps_tpu_torch.__path__, "metamaps_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    sys.path.insert(0, sys.argv[1])
    import chip_smoke
    print("imported", len(names), "and chip_smoke")

    sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
    from util_db import make_mini_db, write_reads_fastq
    from util_sim import random_genome, sample_reads
    from util_torch import write_gene_annotations
    from metamaps_tpu_torch.cli import main
    from metamaps_tpu_torch.io.mappings import read_meta

    root = sys.argv[2]
    db = os.path.join(root, "DB")
    rng = np.random.default_rng(7)
    genomes, contigs, _ = make_mini_db(db, rng, n_genomes=2, genome_len=30000)
    reads = sample_reads(rng, genomes, 6, min_len=2000, max_len=4000, sub=0.05)
    reads.append((random_genome(rng, 500), -1, 0, 1))
    fq = os.path.join(root, "reads.fastq")
    write_reads_fastq(fq, reads)
    out = os.path.join(root, "out")
    stats = {}
    assert main(["mapDirectly", "--reference", os.path.join(db, "DB.fa"),
                 "--query", fq, "--output", out, "--all", "--minReadLen",
                 "1000", "--mapping-engine", "torch", "--device", "cpu"],
                engine_stats=stats) == 0
    assert main(["classify", "--DB", db, "--mappings", out,
                 "--device", "cpu"]) == 0
    meta = read_meta(out)
    assert meta["TotalReads"] == 7 and meta["ReadsTooShort"] == 1, meta
    assert meta["ReadsMapped"] == 6, meta
    assert stats["l2_candidates"] > 0 and stats["oracle_fallbacks"] == 0, stats
    assert os.path.getsize(out + ".EM.WIMP") > 0

    write_gene_annotations(db, contigs[0], 30000)
    assert main(["geneLevelAnalysis", "--DB", db, "--mappings", out]) == 0
    assert os.path.getsize(out + ".EM.geneLevelAnalysis") > 0
    assert main(["filterWIMP", "--DB", db, "--mappings", out]) == 0
    assert os.path.getsize(out + ".EM.WIMP.filteredByIdentity") > 0
    for target in ("kraken", "centrifuge", "mash"):
        assert main(["convertDB", "--DB", db, "--to", target, "--output",
                     os.path.join(root, "conv_" + target)]) == 0
    prot = os.path.join(root, "prot.faa")
    with open(prot, "w") as f:
        for i in range(4):
            f.write(f">WP_{i}.1\\n" + "M" * 40 + "\\n")
    annot = os.path.join(root, "annot.txt")
    for action in ("split", "submit"):
        assert main(["splitEggNog", "--action", action, "--input", prot,
                     "--output", annot, "--targetChars", "50"]) == 0
    n_chunks = 0
    while os.path.exists(f"{annot}.split.i.{n_chunks + 1}"):
        n_chunks += 1
        with open(f"{annot}.split.o.{n_chunks}.emapper.annotations", "w") as f:
            f.write("#\\n#\\n#\\n#query_name\\tGO_terms\\tKEGG_KOs\\t"
                    "BiGG_reactions\\tOGs\\tCOG cat\\n")
    assert n_chunks == 2  # two 49-character records a chunk
    assert main(["splitEggNog", "--action", "collect", "--input", prot,
                 "--output", annot]) == 0
    assert main(["evaluateExternal", "--DB", db, "--truth",
                 out + ".EM.reads2Taxon", "--fastq", fq, "--method",
                 f"metamaps={out}.EM.reads2Taxon:{out}.EM.WIMP", "--output",
                 os.path.join(root, "eval"), "--plots"]) == 0
    assert os.path.getsize(os.path.join(root, "eval.readLevel.tsv")) > 0
    assert main(["plotIdentities", "--mappings", out]) == 0
    assert main(["downloadRefSeq", "--targetDir",
                 os.path.join(root, "dl")]) == 0
    out_mesh = os.path.join(root, "out_mesh")
    assert main(["mapDirectly", "--reference", os.path.join(db, "DB.fa"),
                 "--query", fq, "--output", out_mesh, "--all", "--minReadLen",
                 "1000", "--mesh", "shard=2,data=2", "--device", "cpu"]) == 0
    assert open(out_mesh).read() == open(out).read()
    assert main(["classify", "--DB", db, "--mappings", out_mesh,
                 "--emBackend", "sharded", "--device", "cpu"]) == 0
    assert os.path.getsize(out_mesh + ".EM.WIMP") > 0

    with open(os.path.join(db, "selfSimilarities.txt"), "w") as f:
        for rl in (2000, 5000):
            for idty, p in ((84, 0.2), (88, 0.6), (92, 0.2)):
                f.write(f"100\\t{rl}\\t{idty}\\t{p}\\t\\n")
    idx = os.path.join(root, "idx")
    out2 = os.path.join(root, "out2")
    assert main(["index", "--reference", os.path.join(db, "DB.fa"),
                 "--index", idx, "--minReadLen", "1000"]) == 0
    stats = {}
    assert main(["mapAgainstIndex", "--index", idx, "--query", fq,
                 "--output", out2, "--all", "--mapping-engine", "torch",
                 "--device", "cpu"], engine_stats=stats) == 0
    assert len(stats["shard_load_s"]) == 1, stats
    assert stats["oracle_fallbacks"] == 0, stats
    assert read_meta(out2) == meta
    assert main(["classify", "--DB", db, "--mappings", out2, "--minreads",
                 "2", "--device", "cpu"]) == 0
    assert main(["classifyU", "--DB", db, "--mappings", out2, "--minreads",
                 "2"]) == 0
    for suffix in (".mapQ_U", ".U.WIMP", ".U.reads2Taxon", ".EM2U.summary"):
        assert os.path.getsize(out2 + suffix) > 0, suffix

    synth = os.path.join(root, "synth")
    assert main(["synthDB", "--out", synth, "--genera", "2",
                 "--speciesPerGenus", "2", "--genomeLen", "30000", "--seed",
                 "5"]) == 0
    run_stats = {}
    assert main(["experiments", "--DB", synth, "--store",
                 os.path.join(root, "store"), "--name", "tiny", "--nReads",
                 "12", "--holdout", "auto1", "--meanLength", "3000", "--seed",
                 "2", "--device", "cpu"], engine_stats=run_stats) == 0
    assert set(run_stats["runs"]) == {"full__metamaps", "holdout__metamaps"}
    assert os.path.getsize(os.path.join(root, "store", "tiny",
                                        "results.json")) > 0

    tax = os.path.join(root, "tax")
    os.makedirs(tax)
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        for node, name in ((1, "all"), (50, "G"), (500, "S")):
            f.write(f"{node}\\t|\\t{name}\\t|\\t\\t|\\tscientific name\\t|\\n")
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        for node, parent, rank in ((1, 1, "no rank"), (50, 1, "genus"),
                                   (500, 50, "species")):
            f.write(f"{node}\\t|\\t{parent}\\t|\\t{rank}\\t|\\n")
    fastas = []
    for i in range(2):
        fastas.append(os.path.join(root, f"g{i}.fa"))
        with open(fastas[-1], "w") as f:
            f.write(f">g{i}\\n{random_genome(rng, 5000).tobytes().decode()}\\n")
    annotated = os.path.join(root, "annotated.fa")
    assert main(["annotate", "--genomes", ",".join(f"{fa}=500" for fa in fastas),
                 "--output", annotated, "--taxonomy", tax]) == 0
    db2 = os.path.join(root, "DB2")
    assert main(["buildDB", "--DB", db2, "--FASTAs", annotated, "--taxonomy",
                 tax]) == 0
    assert main(["validateDB", "--DB", db2]) == 0
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("ok")
    """
)


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, REPO, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
