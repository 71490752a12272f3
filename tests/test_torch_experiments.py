"""The port's ``experiments`` against the JAX package's, on the fixture of
``tests/test_experiments.py`` (5 genomes x 30 kb, 40 reads, a two-taxon
leave-out, seed 3, tools metamaps and kraken2; kraken2 is not installed,
so both stores record it as skipped): the JAX package with its serial
oracle, the port with its torch engine and with its oracle engine, both on
the CPU. Every file of the store is byte-identical, the plots aside (a PDF
carries the time it was made). A failed metamaps run fails the port's
command and is never recorded as skipped; without CUDA, ``--device cuda``
raises before anything is written."""
import json
import os

import numpy as np
import pytest
import torch

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.sim import experiments as port_experiments

from util_db import make_mini_db
from util_torch import one_torch_thread, run_in, tree_bytes  # noqa: F401  (autouse fixture)

ARGS = ["--name", "exp1", "--nReads", "40", "--holdout", "auto2", "--seed",
        "3", "--tools", "metamaps,kraken2", "--meanLength", "4000"]
PORT_RUNS = {"torch": ["--engine", "torch", "--device", "cpu"],
             "oracle": ["--engine", "oracle", "--device", "cpu"]}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_experiments")
    db = str(root / "DB")
    make_mini_db(db, np.random.default_rng(777), n_genomes=5,
                 genome_len=30000)
    out = {"jax": str(root / "jax")}
    assert run_in(out["jax"], jax_cli_main, [
        "experiments", "--DB", "../DB", "--store", "store", *ARGS,
        "--engine", "oracle"]) == 0
    run_stats = {}
    for name, extra in PORT_RUNS.items():
        out[name] = str(root / name)
        assert run_in(out[name], port_cli_main, [
            "experiments", "--DB", "../DB", "--store", "store", *ARGS,
            *extra], engine_stats=run_stats if name == "torch" else None) == 0
    return root, db, out, run_stats


@pytest.mark.parametrize("engine", sorted(PORT_RUNS))
def test_store_is_the_jax_packages(stores, engine):
    _, _, out, _ = stores
    want = tree_bytes(out["jax"])
    got = tree_bytes(out[engine])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    results = json.loads(want["store/exp1/results.json"])
    assert set(results) == {"full__metamaps", "full__kraken2",
                            "holdout__metamaps", "holdout__kraken2"}
    assert "skipped" in results["full__kraken2"]
    assert "not found on PATH" in results["holdout__kraken2"]["skipped"]


def test_run_stats_report_each_step(stores):
    _, _, _, run_stats = stores
    assert run_stats["simulate_s"] > 0
    assert set(run_stats["reduced_db_s"]) == {"holdout"}
    runs = run_stats["runs"]
    for key in ("full__metamaps", "holdout__metamaps"):
        r = runs[key]
        for name in ("mapDirectly_s", "classify_s", "evaluate_s", "map_s"):
            assert r[name] > 0, (key, name)
        assert r["reads_total"] == 40 and r["oracle_fallbacks"] == 0
        assert r["l2_candidates"] > 0
    assert runs["full__kraken2"] == {}


def test_rerun_resumes_from_the_flags(stores, capsys):
    """A second run over a finished store recomputes nothing and writes
    the same results.json."""
    _, db, out, _ = stores
    before = tree_bytes(out["torch"])
    run_stats = {}
    assert run_in(out["torch"], port_cli_main, [
        "experiments", "--DB", "../DB", "--store", "store", *ARGS,
        *PORT_RUNS["torch"]], engine_stats=run_stats) == 0
    assert "2/4 runs completed" in capsys.readouterr().out
    assert run_stats == {}
    assert tree_bytes(out["torch"]) == before


def test_failed_metamaps_run_fails_the_command(stores, tmp_path, monkeypatch):
    _, db, _, _ = stores

    def fail(*args, **kwargs):
        raise RuntimeError("the mapping engine failed")

    monkeypatch.setattr(port_experiments, "run_inference", fail)
    store = str(tmp_path / "store")
    with pytest.raises(RuntimeError, match="the mapping engine failed"):
        port_cli_main(["experiments", "--DB", db, "--store", store, *ARGS,
                       *PORT_RUNS["torch"]])
    run = os.path.join(store, "exp1", "runs", "full__metamaps")
    assert os.path.isdir(run)
    assert not os.path.exists(run + ".ok")
    assert not os.path.exists(os.path.join(run, "metrics.json"))
    assert not os.path.exists(os.path.join(store, "exp1", "results.json"))


@pytest.mark.parametrize("argv", [
    ["experiments", "--store", "{tmp}/store", *ARGS],
    ["simulate", "--action", "inference", "--out", "{tmp}/inf", "--reads",
     "{tmp}/reads.fastq"],
], ids=["experiments", "simulate_inference"])
def test_device_cuda_raises_without_cuda(stores, tmp_path, monkeypatch, argv):
    _, db, _, _ = stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(tmp=tmp_path) for a in argv] + ["--DB", db]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli_main(argv)
    assert os.listdir(tmp_path) == []
