"""The port's copies of the JAX package's host modules (``params``,
``stats``, ``taxonomy``, ``io.fasta``, ``io.mappings``, ``io.native``,
``sim.synth_db``) give the same values and bytes as the originals on the
same inputs. Exact equality throughout: the copies run the same code."""
import os

import numpy as np
import pytest

from metamaps_tpu import params as jax_params
from metamaps_tpu import stats as jax_stats
from metamaps_tpu import taxonomy as jax_taxonomy
from metamaps_tpu.io import fasta as jax_fasta
from metamaps_tpu.io import mappings as jax_mappings
from metamaps_tpu.io import native as jax_native
from metamaps_tpu.sim import synth_db as jax_synth
from metamaps_tpu_torch import params, stats, taxonomy
from metamaps_tpu_torch.io import fasta, mappings, native
from metamaps_tpu_torch.sim import synth_db

from util_db import make_mini_db
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "mapped")


def test_stats_same_values():
    rng = np.random.default_rng(3)
    for j in rng.random(20):
        assert stats.j2md(j, 16) == jax_stats.j2md(j, 16)
        assert stats.md2j(j, 16) == jax_stats.md2j(j, 16)
    s = rng.integers(50, 2000, 40)
    p = rng.random(40) * 0.2
    np.testing.assert_array_equal(
        stats.binom_quantile_complement_vec(s, p, 0.9),
        jax_stats.binom_quantile_complement_vec(s, p, 0.9))
    shared = rng.integers(0, 200, 40)
    np.testing.assert_array_equal(stats.acceptance_vec(shared, s, 16, 80.0),
                                  jax_stats.acceptance_vec(shared, s, 16, 80.0))
    for size in (100, 785, 2000):
        for pi in (75.0, 80.0, 90.0):
            assert (stats.estimate_minimum_hits(size, 16, pi)
                    == jax_stats.estimate_minimum_hits(size, 16, pi))
    assert (stats.recommended_window_size(1e-3, 16, 4, 80.0, 2000, 26762276280)
            == jax_stats.recommended_window_size(1e-3, 16, 4, 80.0, 2000,
                                                 26762276280))


def test_params_derive_the_same_window():
    for pval, window in ((1e-3, None), (1e-5, None), (1e-3, 24)):
        got, want = params.Parameters(), jax_params.Parameters()
        for p in (got, want):
            p.kmer_size, p.p_value, p.reference_size = 16, pval, 10**8
            if window is not None:
                p.window_size = window
            p.derive_window_size(window_size_given=window is not None)
        assert (got.window_size, got.p_value) == (want.window_size,
                                                  want.p_value)


def test_mappings_parse_the_same():
    got = list(mappings.iter_reads_grouped(GOLDEN))
    assert got == list(jax_mappings.iter_reads_grouped(GOLDEN))
    for read_lines in got:
        for line in read_lines:
            ml = mappings.parse_mapping_line(line)
            want = jax_mappings.parse_mapping_line(line)
            assert vars(ml) == vars(want)
            assert ml.format() == want.format() == line
    assert mappings.read_meta(GOLDEN) == jax_mappings.read_meta(GOLDEN)
    assert (list(mappings.read_unmapped_lengths(GOLDEN))
            == list(jax_mappings.read_unmapped_lengths(GOLDEN)))
    for x in (0.0, 1.0, 0.123456789, 1e-7, 3.5e12):
        assert mappings.fmt_g(x) == jax_mappings.fmt_g(x)


def test_native_parser_and_winnower_the_same():
    got = native.parse_mappings_native(GOLDEN)
    want = jax_native.parse_mappings_native(GOLDEN)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.keys() == want.keys()
        for key in got:
            if isinstance(got[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key])
            else:
                assert got[key] == want[key]
    seq = np.random.default_rng(1).choice(np.frombuffer(b"ACGT", np.uint8), 5000)
    got = native.winnow_native(seq, 16, 8)
    want = jax_native.winnow_native(seq, 16, 8)
    assert (got is None) == (want is None)
    if got is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_native_libraries_build_outside_the_sources():
    if native._build_and_load_winnow() is None:
        pytest.skip("no g++ here: the port falls back to numpy")
    built = native._compile("winnow.cpp", "libwinnow.so", ["-O3"])
    assert os.path.dirname(built) == native._BUILD_DIR
    assert os.path.basename(os.path.dirname(built)) == "metamaps_tpu_torch"


def test_fasta_and_taxonomy_the_same(tmp_path):
    db = str(tmp_path / "DB")
    make_mini_db(db, np.random.default_rng(4), n_genomes=3, genome_len=5000)
    fa = os.path.join(db, "DB.fa")
    got = list(fasta.read_sequences(fa))
    want = list(jax_fasta.read_sequences(fa))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert fasta.total_file_size([fa]) == jax_fasta.total_file_size([fa])
    tax = taxonomy.Taxonomy(os.path.join(db, "taxonomy"))
    jtax = jax_taxonomy.Taxonomy(os.path.join(db, "taxonomy"))
    for node in ("1000", "1001", "100", "30", "1"):
        assert tax.get_upward_nodes(node) == jtax.get_upward_nodes(node)
        assert (tax.get_upward_by_ranks(node, {"species", "genus"})
                == jtax.get_upward_by_ranks(node, {"species", "genus"}))
        assert (tax.get_node(node).scientific_name
                == jtax.get_node(node).scientific_name)
    assert (tax.lowest_common_ancestor(["1000", "1002"])
            == jtax.lowest_common_ancestor(["1000", "1002"]))
    name = "C0|kraken:taxid|1000|ACC0.1"
    assert taxonomy.extract_taxon_id(name) == jax_taxonomy.extract_taxon_id(name)


def test_synth_db_same_bytes(tmp_path):
    paths = []
    for mod, sub in ((synth_db, "port"), (jax_synth, "jax")):
        rng = np.random.default_rng(9)
        path = str(tmp_path / sub)
        mod.write_synth_db_dir(path, rng, n_genera=2, species_per_genus=2,
                               genome_len=6000, homolog_len=500,
                               homolog_pool=3)
        read = mod.ont_read(rng, np.frombuffer(b"ACGT" * 500, np.uint8), 800)
        paths.append((path, read))
    (a, read_a), (b, read_b) = paths
    np.testing.assert_array_equal(read_a, read_b)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for root, _, files in os.walk(a):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), a)
            with open(os.path.join(a, rel), "rb") as fa, \
                    open(os.path.join(b, rel), "rb") as fb:
                assert fa.read() == fb.read(), rel
