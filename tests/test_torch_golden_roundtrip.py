"""The committed goldens (``tests/goldens/``, written by ``regen.py``
through the JAX package's CLI with its serial oracle) reproduced byte for
byte by the port's pipeline on the CPU: ``regen.py``'s seeded data, then
the port's ``mapDirectly --mapping-engine torch --device cpu`` and
``classify`` with ``--emBackend numpy`` and with the port's default
backend on ``--device cpu``. The goldens are read, never written."""
import os
import sys

import numpy as np
import pytest

from metamaps_tpu_torch.cli import main as port_cli_main

from util_db import make_mini_db, write_reads_fastq
from util_sim import random_genome, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
sys.path.insert(0, GOLDENS)
from regen import GOLDEN_FILES  # noqa: E402

EM_GOLDENS = [f for f in GOLDEN_FILES if ".EM" in f]


def golden(fn: str) -> bytes:
    with open(os.path.join(GOLDENS, fn), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """``regen.run_pipeline``'s database and reads, mapped by the port's
    torch engine on the CPU; returns the output prefix."""
    out_dir = str(tmp_path_factory.mktemp("golden"))
    rng = np.random.default_rng(20260821)
    db = os.path.join(out_dir, "DB")
    genomes, _, _ = make_mini_db(db, rng, n_genomes=5, genome_len=30000)
    reads = sample_reads(rng, genomes, 40, min_len=2200, max_len=5000,
                         sub=0.06)
    short = sample_reads(rng, genomes, 4, min_len=600, max_len=900, sub=0.06)
    alien = [(random_genome(rng, 3000),), (random_genome(rng, 4200),)]
    fq = os.path.join(out_dir, "reads.fastq")
    write_reads_fastq(fq, reads + short + alien)
    prefix = os.path.join(out_dir, "mapped")
    assert port_cli_main([
        "mapDirectly", "--reference", os.path.join(db, "DB.fa"),
        "--query", fq, "--output", prefix, "--all", "--minReadLen", "2000",
        "--mapping-engine", "torch", "--device", "cpu"]) == 0
    return db, prefix


def test_torch_engine_writes_the_golden_mappings(mapped):
    _, prefix = mapped
    for fn in GOLDEN_FILES:
        if ".EM" not in fn:
            with open(os.path.dirname(prefix) + "/" + fn, "rb") as f:
                assert f.read() == golden(fn), fn


@pytest.mark.parametrize("backend", [["--emBackend", "numpy"],
                                     ["--device", "cpu"]],
                         ids=["numpy", "default"])
def test_classify_writes_the_golden_em_files(mapped, backend):
    db, prefix = mapped
    assert port_cli_main(["classify", "--DB", db, "--mappings", prefix]
                         + backend) == 0
    for fn in EM_GOLDENS:
        with open(os.path.dirname(prefix) + "/" + fn, "rb") as f:
            assert f.read() == golden(fn), fn
