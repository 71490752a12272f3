"""The port's EM (``metamaps_tpu_torch.engine.em``) against the JAX package's
host float64 EM (``metamaps_tpu.engine.em``).

- one torch round on the CPU against ``em_iterate`` on the same table: the
  log-likelihood within 1e-12 relative, f within 1e-12 absolute, round for
  round;
- ``run_em`` with the torch round takes the same number of rounds;
- ``classify`` through the port's CLI (``--device cpu``) writes the same
  bytes as ``metamaps_tpu.cli classify --emBackend numpy`` in all seven
  ``.EM*`` files, on a ``make_mini_db`` database.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.engine import em as jax_em
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.engine import em as port_em

from util_db import make_mini_db, write_reads_fastq
from util_sim import random_genome, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

EM_FILES = (".EM", ".EM.WIMP", ".EM.reads2Taxon", ".EM.reads2Taxon.krona",
            ".EM.contigCoverage", ".EM.evidenceUnknownSpecies",
            ".EM.lengthAndIdentitiesPerMappingUnit")
LL_RTOL = 1e-12
F_ATOL = 1e-12


def synthetic_table(seed: int, n_reads: int = 3000, n_tax: int = 40):
    """A mapping table with ambiguous reads: 1-6 lines per read over
    skewed taxa, mapQ summing to one per read."""
    rng = np.random.default_rng(seed)
    per_read = rng.integers(1, 7, n_reads)
    read_of_line = np.repeat(np.arange(n_reads), per_read)
    n_lines = read_of_line.size
    weights = rng.dirichlet(np.full(n_tax, 0.3))
    taxon_of_line = rng.choice(n_tax, n_lines, p=weights).astype(np.int32)
    raw = rng.random(n_lines) ** 3 + 1e-9
    mapq = raw / np.bincount(read_of_line, weights=raw)[read_of_line]
    inv_loc = 1.0 / rng.integers(10_000, 5_000_000, n_lines)
    return port_em.MappingTable(
        lines=[], read_of_line=read_of_line.astype(np.int64),
        taxon_of_line=taxon_of_line, mapq=mapq, inv_locations=inv_loc,
        identity=np.ones(n_lines), contig_of_line=[], start=None, stop=None,
        read_len=None, read_ids=[f"r{i}" for i in range(n_reads)],
        taxon_list=[str(t) for t in range(n_tax)])


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A mini DB and the port's mapDirectly mappings of its reads."""
    root = tmp_path_factory.mktemp("em")
    db = str(root / "DB")
    rng = np.random.default_rng(11)
    genomes, _, _ = make_mini_db(db, rng, n_genomes=3, genome_len=40000)
    reads = sample_reads(rng, genomes, 24, min_len=2000, max_len=5000, sub=0.06)
    reads.append((random_genome(rng, 500), -1, 0, 1))  # too short
    reads.append((random_genome(rng, 3000), -1, 0, 1))  # unmapped
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)
    out = str(root / "map" / "out")
    os.makedirs(os.path.dirname(out))
    assert port_cli_main([
        "mapDirectly", "--reference", os.path.join(db, "DB.fa"),
        "--query", fq, "--output", out, "--all", "--minReadLen", "1000",
        "--device", "cpu"]) == 0
    return root, db, out


def _copy_mappings(out: str, dest_dir: str) -> str:
    """Copy a mappings file and its sidecars into ``dest_dir``."""
    os.makedirs(dest_dir)
    folder, base = os.path.split(out)
    for name in os.listdir(folder):
        if name.startswith(base):
            shutil.copy(os.path.join(folder, name), dest_dir)
    return os.path.join(dest_dir, base)


def _mini_table(mini):
    _, db, out = mini
    info = port_em.load_relevant_taxon_info(db, set())
    return port_em.load_mapping_table(out, info)


@pytest.mark.parametrize("source", ["mini_db", "synthetic_0", "synthetic_1"])
def test_torch_round_matches_em_iterate(mini, source):
    table = (_mini_table(mini) if source == "mini_db"
             else synthetic_table(int(source[-1])))
    step = port_em.make_em_iterate_torch(table, "cpu")
    n_tax = len(table.taxon_list)
    f = np.full(n_tax, 1.0 / n_tax)
    for _ in range(6):
        want_f, want_ll = jax_em.em_iterate(table, f)
        got_f, got_ll = step(f)
        assert got_f.dtype == np.float64 and got_f.shape == want_f.shape
        assert abs(got_ll - want_ll) <= LL_RTOL * abs(want_ll)
        np.testing.assert_allclose(got_f, want_f, rtol=0, atol=F_ATOL)
        f = want_f


@pytest.mark.parametrize("source", ["mini_db", "synthetic_0"])
def test_run_em_same_round_count(mini, source):
    table = (_mini_table(mini) if source == "mini_db"
             else synthetic_table(0))
    want_f, want_n = jax_em.run_em(table, verbose=False, backend="numpy")
    got_f, got_n = port_em.run_em(table, verbose=False, backend="torch",
                                  device="cpu")
    assert got_n == want_n
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=F_ATOL)
    host_f, host_n = port_em.run_em(table, verbose=False, backend="numpy")
    assert host_n == want_n and np.array_equal(host_f, want_f)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_classify_byte_identical_to_jax(mini, tmp_path, backend):
    root, db, out = mini
    want = _copy_mappings(out, str(tmp_path / "jax"))
    got = _copy_mappings(out, str(tmp_path / "port"))
    assert jax_cli_main(["classify", "--DB", db, "--mappings", want,
                         "--emBackend", "numpy"]) == 0
    assert port_cli_main(["classify", "--DB", db, "--mappings", got,
                          "--emBackend", backend, "--device", "cpu"]) == 0
    for suffix in EM_FILES:
        with open(want + suffix, "rb") as a, open(got + suffix, "rb") as b:
            want_bytes, got_bytes = a.read(), b.read()
        assert want_bytes, suffix
        assert got_bytes == want_bytes, suffix


def test_classify_raises_without_cuda(mini, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, db, out = mini
    got = _copy_mappings(out, str(tmp_path / "port"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli_main(["classify", "--DB", db, "--mappings", got])
    assert not os.path.exists(got + ".EM")


#: the port's own device and engine options: ``--device`` (cuda or cpu)
#: is the port's alone, and the engine and EM backend options name the
#: torch engine and rounds where the JAX package's name ``jax``
PORT_DEVICE_OPTIONS = ("--device", "--engine", "--mapping-engine",
                       "--emBackend")


def _jax_parser():
    """The JAX package's parser: ``metamaps_tpu.cli.main`` builds it and
    parses at once, so the parse is intercepted."""
    import argparse

    from metamaps_tpu import cli as jax_cli

    class Built(Exception):
        pass

    def grab(parser, *args, **kwargs):
        raise Built(parser)

    parse = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        jax_cli.main(["index"])
    except Built as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = parse
    raise AssertionError("the JAX CLI parsed nothing")


def _options(parser) -> dict:
    """{subcommand: {option strings (or a positional's dest): (default,
    choices, required, action, metavar, nargs, type, dest)}}."""
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        out[name] = {
            tuple(a.option_strings) or a.dest: (
                a.default, None if a.choices is None else list(a.choices),
                a.required, type(a).__name__, a.metavar, a.nargs, a.type,
                a.dest)
            for a in p._actions if not isinstance(a, argparse._HelpAction)}
    return out


def test_every_jax_subcommand_is_ported():
    """The port's parser has every subcommand of the JAX package's, and no
    other; each with the same option strings, defaults, choices, required,
    action, metavar, nargs, type and dest. Only the port's device and
    engine options (``PORT_DEVICE_OPTIONS``) may differ or be the port's
    alone, and they keep every JAX choice that names no JAX backend."""
    from metamaps_tpu_torch.cli import _parser

    want, got = _options(_jax_parser()), _options(_parser())
    assert sorted(got) == sorted(want)
    assert len(want) == 28
    for name in want:
        for key in sorted(set(want[name]) | set(got[name]), key=str):
            if key in [(o,) for o in PORT_DEVICE_OPTIONS]:
                assert key in got[name], (name, key)
                if key in want[name]:
                    kept = set(want[name][key][1]) - {"jax", "auto"}
                    assert kept <= set(got[name][key][1]), (name, key)
                continue
            assert got[name].get(key) == want[name].get(key), (name, key)
    # the device option is on every subcommand that runs the card
    for name in ("mapDirectly", "mapAgainstIndex", "classify", "experiments",
                 "simulate"):
        assert got[name][("--device",)][:2] == ("cuda", ["cuda", "cpu"])


def test_em_bench_round_matches_jax_on_cpu():
    """The EM bench's synthetic table (bench.py's layout) at a small size:
    its torch round on the CPU against the JAX package's host round, ll
    within 1e-12 relative and f within 1e-12 absolute."""
    from metamaps_tpu_torch.profiling import em_bench

    rows = em_bench.run("cpu", sizes=(4002,), reps=1, log=lambda m: None)
    assert rows[0]["lines"] == 4000 and rows[0]["reads"] == 1000
    table = em_bench.synthetic_table(np.random.default_rng(9), 4000, 50)
    f = np.full(50, 1 / 50)
    got_f, got_ll = port_em.make_em_iterate_torch(table, "cpu")(f)
    want_f, want_ll = jax_em.em_iterate(table, f)
    assert abs(got_ll - want_ll) <= 1e-12 * abs(want_ll)
    assert np.abs(got_f - want_f).max() <= 1e-12
