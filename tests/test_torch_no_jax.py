"""The port stands alone: with ``jax``, ``jaxlib`` and the JAX package
``metamaps_tpu`` blocked on ``sys.meta_path``, every ``metamaps_tpu_torch``
module and ``chip_smoke.py`` import, and ``mapDirectly`` + ``classify``,
then ``index`` -> ``mapAgainstIndex`` -> ``classify`` -> ``classifyU``, run
through the port's CLI on a tiny database (torch engine and EM rounds on
the CPU)."""
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
    from metamaps_tpu_torch.cli import main
    from metamaps_tpu_torch.io.mappings import read_meta

    root = sys.argv[2]
    db = os.path.join(root, "DB")
    rng = np.random.default_rng(7)
    genomes, _, _ = make_mini_db(db, rng, n_genomes=2, genome_len=30000)
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
