"""The port's multi-device spatial path (``metamaps_tpu_torch.parallel``)
against the JAX package's (``metamaps_tpu.parallel``), with every rank on
the CPU.

- ``parse_mesh_spec``, the two contig partitions and the read-atomic line
  partition equal the JAX functions;
- ``mapDirectly --mesh S,D --device cpu`` writes, byte for byte in the
  mappings, ``.meta``, ``.meta.unmappedReadsLengths`` and the normalised
  ``.parameters``, what the port's one-device run and the JAX package's
  one-device run (its serial oracle engine, which its own tests pin to its
  device engine) write, and what the JAX package's own mesh run writes
  with and without ``--all``; the comma-separated multi-query form too;
- ``ShardedMapperEngine.map_reads`` on eight ranks gives, per partition,
  what a one-partition ``TorchMapperEngine`` gives (the contract of the
  JAX package's per-partition candidate grids);
- the sharded EM tracks the host EM round for round, ``classify
  --emBackend sharded`` writes the numpy backend's bytes in all seven
  ``.EM*`` files, and ``auto`` resolves as the JAX package's rule does.
The database is ``tests/test_sharded_product.py``'s: 6 genomes x 24 kb and
24 reads, ``--minReadLen 2000``.
"""
import os
import shutil

import numpy as np
import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.engine import em as jax_em
from metamaps_tpu.engine.index import build_shards as jax_build_shards
from metamaps_tpu.params import Parameters as JaxParameters
from metamaps_tpu.parallel import mesh as jax_mesh
from metamaps_tpu.parallel import sharded_engine as jax_se
from metamaps_tpu.parallel import sharded_map as jax_sm
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.engine import em as port_em
from metamaps_tpu_torch.engine.index import build_shards
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.io.fasta import read_sequences
from metamaps_tpu_torch.io.mappings import read_meta
from metamaps_tpu_torch.parallel import mesh as port_mesh
from metamaps_tpu_torch.parallel import sharded_engine as port_se
from metamaps_tpu_torch.parallel import sharded_map as port_sm
from metamaps_tpu_torch.params import Parameters
from metamaps_tpu_torch.profiling.em_bench import synthetic_table

from util_db import make_mini_db, write_reads_fastq
from util_sim import sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

SIDECARS = ("", ".meta", ".meta.unmappedReadsLengths", ".parameters")
EM_FILES = (".EM", ".EM.WIMP", ".EM.reads2Taxon", ".EM.reads2Taxon.krona",
            ".EM.contigCoverage", ".EM.evidenceUnknownSpecies",
            ".EM.lengthAndIdentitiesPerMappingUnit")
PART_FIELDS = ("hash_pos_order", "wpos", "strand", "seqid", "hash_sorted",
               "contig_offsets")
# the JAX mesh run's small compiled shapes keep its XLA-CPU compile short
JAX_MESH = ["--mesh", "shard=2,data=2", "--meshBuckets", "4096",
            "--meshRows", "8"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The mini database, its reads, and the one-device runs: the port's
    (torch engine on the CPU) and the JAX package's (serial oracle)."""
    root = tmp_path_factory.mktemp("mesh")
    db = str(root / "DB")
    rng = np.random.default_rng(20240817)
    genomes, _, _ = make_mini_db(db, rng, n_genomes=6, genome_len=24000)
    reads = sample_reads(rng, genomes, 24, min_len=2200, max_len=4000,
                         sub=0.07)
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)
    port1 = str(root / "port_single" / "out")
    jax1 = str(root / "jax_single" / "out")
    for path in (port1, jax1):
        os.makedirs(os.path.dirname(path))
    assert port_cli_main(_map_argv(db, fq, port1)
                         + ["--device", "cpu"]) == 0
    assert jax_cli_main(_map_argv(db, fq, jax1)
                        + ["--mapping-engine", "oracle"]) == 0
    return root, db, fq, port1, jax1


def _map_argv(db, fq, out, report_all=True):
    return (["mapDirectly", "--reference", os.path.join(db, "DB.fa"),
             "--query", fq, "--output", out, "--minReadLen", "2000"]
            + (["--all"] if report_all else []))


def _sidecars(prefix):
    """The mapping file and its sidecars; ``.parameters`` without the line
    that names the run's own output (mapWrap.h:196-211)."""
    out = {}
    for suffix in SIDECARS:
        text = open(prefix + suffix).read()
        if suffix == ".parameters":
            text = "\n".join(l for l in text.splitlines()
                              if not l.startswith("outFileName "))
        out[suffix] = text
    return out


def _assert_same_files(want, got):
    a, b = _sidecars(want), _sidecars(got)
    assert a[""], "no mapping lines"
    for suffix in SIDECARS:
        assert a[suffix] == b[suffix], f"{suffix or 'mappings'} differs"


def _full_shards(db):
    """The whole mini database as one index, built by each package."""
    fa = os.path.join(db, "DB.fa")
    out = []
    for build, cls in ((build_shards, Parameters),
                       (jax_build_shards, JaxParameters)):
        shards = []
        build(cls(kmer_size=16, window_size=16, ref_sequences=[fa]), 0,
              lambda s, n: shards.append(s))
        out.append(shards[0])
    return out


@pytest.mark.parametrize("spec", ["shard=4,data=2", "shard=8", "data=4",
                                  "shard=2,,data=3", "tp=2", "shard=0"])
def test_parse_mesh_spec_equals_jax(spec):
    try:
        want = jax_se.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            port_se.parse_mesh_spec(spec)
        return
    assert port_se.parse_mesh_spec(spec) == want


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 8])
def test_partitions_equal_jax(setup, n_parts):
    """Both contig partitions: the contig names, minimizer arrays and
    frequency threshold of every part."""
    _, db, _, _, _ = setup
    port_full, jax_full = _full_shards(db)
    for port_fn, jax_fn in (
            (port_se.partition_contigs_blocks, jax_se.partition_contigs_blocks),
            (port_sm.partition_contigs, jax_sm.partition_contigs)):
        got, want = port_fn(port_full, n_parts), jax_fn(jax_full, n_parts)
        assert len(got) == len(want) == n_parts
        for g, w in zip(got, want):
            assert g.contig_names == w.contig_names
            assert g.contig_lengths == w.contig_lengths
            assert g.freq_threshold == w.freq_threshold
            for field in PART_FIELDS:
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(w, field))
    blocks = port_se.partition_contigs_blocks(port_full, n_parts)
    assert [n for b in blocks for n in b.contig_names] == port_full.contig_names


@pytest.mark.parametrize("n_parts", [1, 3, 8, 64])
def test_partition_lines_read_atomic_equals_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    read_of_line = np.repeat(np.arange(40), rng.integers(1, 9, 40))
    want = jax_mesh.partition_lines_read_atomic(read_of_line, n_parts)
    assert port_mesh.partition_lines_read_atomic(read_of_line, n_parts) == want
    assert port_mesh.partition_lines_read_atomic(
        np.zeros(0, np.int64), n_parts) == [0] * (n_parts + 1)


@pytest.mark.parametrize("mesh", ["shard=4,data=2", "shard=8,data=1",
                                  "shard=2,data=4", "shard=1,data=1"])
def test_mesh_mapdirectly_equals_one_device(setup, tmp_path, mesh):
    """The port's mesh run on CPU ranks writes the bytes of the port's and
    the JAX package's one-device runs, and removes its per-shard files."""
    _, db, fq, port1, jax1 = setup
    out = str(tmp_path / "out")
    stats = {}
    assert port_cli_main(_map_argv(db, fq, out) + ["--mesh", mesh,
                                                    "--device", "cpu"],
                         engine_stats=stats) == 0
    _assert_same_files(port1, out)
    _assert_same_files(jax1, out)
    assert sorted(os.listdir(tmp_path)) == sorted("out" + s for s in SIDECARS)
    # the counters sum over the blocks, as the shard loop's over its shards
    n_shard, _ = port_se.parse_mesh_spec(mesh)
    assert stats["reads_mappable"] == 24 * n_shard
    assert stats["oracle_fallbacks"] == 0 and stats["l2_candidates"] > 0


@pytest.mark.parametrize("report_all", [True, False], ids=["all", "filtered"])
def test_mesh_mapdirectly_equals_jax_mesh(setup, tmp_path, report_all):
    """The JAX package's own mesh run; without ``--all`` the top-band
    filter applies per shard in both, as in the reference's shard loop
    (computeMap.hpp:546-563, mapWrap.h:417-441)."""
    _, db, fq, _, _ = setup
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli_main(_map_argv(db, fq, want, report_all) + JAX_MESH) == 0
    assert port_cli_main(_map_argv(db, fq, got, report_all) + JAX_MESH
                         + ["--device", "cpu"]) == 0
    _assert_same_files(want, got)


def test_mesh_multi_query_files(setup, tmp_path):
    """Comma-separated query and output lists map file by file."""
    _, db, fq, port1, _ = setup
    lines = open(fq).read().split("\n")
    rec = ["\n".join(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]
    fq_a, fq_b = str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq")
    open(fq_a, "w").write("\n".join(rec[:10]) + "\n")
    open(fq_b, "w").write("\n".join(rec[10:]) + "\n")
    outs = [str(tmp_path / "out_a"), str(tmp_path / "out_b")]
    assert port_cli_main(_map_argv(db, f"{fq_a},{fq_b}", ",".join(outs))
                         + ["--mesh", "shard=3,data=2", "--meshRows", "4",
                            "--device", "cpu"]) == 0
    assert [read_meta(o)["TotalReads"] for o in outs] == [10, 14]
    combined = open(outs[0]).read() + open(outs[1]).read()
    assert combined == open(port1).read()


def test_sharded_engine_per_partition_equals_one_partition(setup):
    """Eight CPU ranks at shard=4,data=2 (three rows per rank block): each
    partition's unfiltered mappings are a one-partition engine's."""
    _, db, fq, _, _ = setup
    port_full, _ = _full_shards(db)
    params = Parameters(kmer_size=16, window_size=16,
                        percentage_identity=80.0)
    seqs = [s for _, s in read_sequences(fq)]
    engine = port_se.ShardedMapperEngine(port_full, params, 4, 2,
                                         rows_per_device=3,
                                         devices=["cpu"] * 8)
    assert engine.mesh.devices.shape == (4, 2)
    got = engine.map_reads(seqs)
    n_lines = 0
    for s, part in enumerate(engine.parts):
        want = TorchMapperEngine(part, params, device="cpu").map_reads(seqs)
        assert got[s] == want
        n_lines += sum(map(len, want))
    assert n_lines >= len(seqs)
    assert engine.stats["oracle_fallbacks"] == 0


def _mesh_table(setup):
    _, db, _, port1, _ = setup
    info = port_em.load_relevant_taxon_info(db, set())
    return port_em.load_mapping_table(port1, info)


@pytest.mark.parametrize("source", ["mini_db", "synthetic"])
def test_sharded_em_tracks_numpy(setup, source):
    """Eight CPU ranks: the round count of the numpy backend, f within
    rtol 1e-12, and ll within 1e-9 relative for four rounds (the
    tolerances of tests/test_end_to_end.py's sharded EM test)."""
    table = (_mesh_table(setup) if source == "mini_db"
             else synthetic_table(np.random.default_rng(5), 40_000, 300))
    ranks = ["cpu"] * 8
    f_np, it_np = jax_em.run_em(table, verbose=False, backend="numpy")
    f_sh, it_sh = port_em.run_em(table, verbose=False, backend="sharded",
                                 device=ranks)
    assert it_sh == it_np
    np.testing.assert_allclose(f_sh, f_np, rtol=1e-12, atol=1e-15)
    step = port_mesh.make_em_iterate_sharded(table, ranks)
    f_a = np.full(len(table.taxon_list), 1.0 / len(table.taxon_list))
    f_b = f_a.copy()
    for _ in range(4):
        f_a, ll_a = jax_em.em_iterate(table, f_a)
        f_b, ll_b = step(f_b)
        assert f_b.dtype == np.float64
        assert abs(ll_a - ll_b) <= 1e-9 * max(1.0, abs(ll_a))


def test_sharded_em_step():
    """``sharded_em_step`` on an 8-rank mesh against the JAX function on
    the 8 virtual CPU devices, both in float64 (the JAX one under x64),
    with each rank's lines out of read order: f and ll within 1e-12
    relative; and the checks of tests/test_sharded_map.py's psum test on
    its inputs."""
    rng = np.random.default_rng(77)
    mesh = port_mesh.make_mesh(8, devices=["cpu"] * 8)
    n_lines, n_reads, n_tax = 256, 64, 6
    read_of_line = np.repeat(np.arange(n_reads),
                             n_lines // n_reads).astype(np.int32)
    # shuffle within each rank's block: every read stays on one rank
    per = n_lines // 8
    perm = np.concatenate([r * per + rng.permutation(per) for r in range(8)])
    read_of_line = read_of_line[perm]
    tax = rng.integers(0, n_tax, n_lines).astype(np.int32)
    mapq = rng.random(n_lines).astype(np.float32)
    inv = np.full(n_lines, 1e-5, np.float32)
    f = np.full(n_tax, 1.0 / n_tax, np.float32)
    f_next, ll = port_mesh.sharded_em_step(mesh, read_of_line, tax, mapq, inv,
                                           f, n_reads)
    with jax_em._X64():
        f_jax, ll_jax = jax_mesh.sharded_em_step(
            jax_mesh.make_mesh(8), read_of_line, tax, mapq.astype(np.float64),
            inv.astype(np.float64), f.astype(np.float64), n_reads)
    assert f_jax.dtype == f_next.dtype == np.float64
    np.testing.assert_allclose(f_next, f_jax, rtol=1e-12)
    assert abs(ll - ll_jax) <= 1e-12 * abs(ll_jax)
    assert abs(f_next.sum() - 1.0) < 1e-4
    l = f[tax] * inv * mapq
    per_read = np.bincount(read_of_line, weights=l, minlength=n_reads)
    ll_ref = np.log(per_read).sum()
    p = l / per_read[read_of_line]
    f_ref = np.bincount(tax, weights=p, minlength=n_tax)
    f_ref /= f_ref.sum()
    np.testing.assert_allclose(f_next, f_ref, rtol=2e-5)
    assert abs(ll - ll_ref) < 1e-3
    with pytest.raises(ValueError):
        port_mesh.sharded_em_step(mesh, read_of_line[:-1], tax[:-1],
                                  mapq[:-1], inv[:-1], f, n_reads)


def test_classify_sharded_byte_identical(setup, tmp_path):
    _, db, _, port1, _ = setup
    outs = {}
    for backend in ("numpy", "sharded"):
        d = tmp_path / backend
        os.makedirs(d)
        for suffix in (".meta", ".meta.unmappedReadsLengths", ""):
            shutil.copy(port1 + suffix, d)
        outs[backend] = str(d / "out")
        assert port_cli_main(["classify", "--DB", db, "--mappings",
                              outs[backend], "--emBackend", backend,
                              "--device", "cpu"]) == 0
    for suffix in EM_FILES:
        with open(outs["numpy"] + suffix, "rb") as a, \
                open(outs["sharded"] + suffix, "rb") as b:
            want, got = a.read(), b.read()
        assert want and got == want, suffix


class _Lines:
    """A mapping table of ``n`` lines, as far as the backend rule reads."""

    def __init__(self, n):
        self.lines = range(n)


@pytest.mark.parametrize("n", [0, 4_999_999, 5_000_000, 12_000_000])
def test_auto_backend_resolves_as_jax(n):
    """On the CPU both rules pick the host; on a card the port's picks the
    device round from 5,000,000 lines, where the JAX rule picks 'jax'."""
    table = _Lines(n)
    assert port_em.EM_AUTO_DEVICE_MIN_LINES == jax_em.EM_AUTO_DEVICE_MIN_LINES
    assert jax_em._resolve_em_backend(table, "auto") == "numpy"
    assert port_em._resolve_em_backend(table, "auto", "cpu") == "numpy"
    want = "torch" if n >= jax_em.EM_AUTO_DEVICE_MIN_LINES else "numpy"
    assert port_em._resolve_em_backend(table, "auto", "cuda") == want
    for backend in ("numpy", "torch", "sharded"):
        assert port_em._resolve_em_backend(table, backend, "cuda") == backend


def test_mesh_needs_its_devices():
    """``--device cuda`` takes cuda:0 .. cuda:S*D-1 and raises with fewer;
    an explicit list must have S*D ranks."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_mesh.make_mesh_2d(1, 1)
    else:
        n = torch.cuda.device_count() + 1
        with pytest.raises(RuntimeError, match="CUDA devices"):
            port_mesh.make_mesh_2d(n, 1)
    with pytest.raises(ValueError, match="8 devices, 4 given"):
        port_mesh.make_mesh_2d(4, 2, devices=["cpu"] * 4)
    mesh = port_mesh.make_mesh_2d(2, 3, devices=[f"cpu:{i}" for i in range(6)])
    assert mesh.shape == {"shard": 2, "data": 3}
    assert [d.index for d in mesh.devices[1]] == [3, 4, 5]
