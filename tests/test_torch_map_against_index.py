"""The port's stored index, ``mapAgainstIndex`` and multi-shard mapping vs
the JAX package, and the engine's routing of sketches too wide for the
batch sweep kernel.

- index files written by the port load in the JAX package and the other
  way round, array for array; the ``.index`` manifest and ``.parameters``
  file match line for line once the prefix is substituted (the ``.npz``
  bytes differ: ``savez_compressed`` stamps zip entries with the time);
- the port's ``mapAgainstIndex`` (torch engine on the CPU, and its serial
  oracle) writes the JAX package's bytes (its serial oracle engine, which
  its own tests pin to its device engine) in the mapping file, ``.meta``,
  ``.meta.unmappedReadsLengths`` and ``.parameters``, over one shard and
  over two, and over either package's index files;
- multi-shard ``mapDirectly`` likewise;
- a slab whose rank planes are wider than ``BATCH_SP_MAX`` goes to the
  wide sweep (planes in device memory) on every device, with the oracle's
  lines, and the constant follows the batch kernel's shared-memory
  formula;
- the vectorised minimum-hits table holds the scalar's values and is
  computed once per process.
Per-shard mappings are not single-shard mappings (each shard has its own
frequency threshold), so each run is compared with the JAX package's run
on the same shards."""
import os
import re

import numpy as np
import pytest
import torch

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.engine import index as jindex
from metamaps_tpu.engine import mapper_oracle as jax_oracle
from metamaps_tpu.engine import mapwrap as jax_mapwrap
from metamaps_tpu.params import Parameters as JaxParameters
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.engine import index as tindex
from metamaps_tpu_torch.engine import mapper_oracle, mapwrap
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.io.fasta import read_sequences, total_file_size
from metamaps_tpu_torch.ops import l1, l2_sweep
from metamaps_tpu_torch.ops import l2 as l2_ops
from metamaps_tpu_torch.params import Parameters

from util_db import make_mini_db, write_reads_fastq
from util_sim import random_genome, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

SHARD_FIELDS = ("seqid", "wpos", "strand", "hash_pos_order", "hash_sorted",
                "seqid_byhash", "wpos_byhash", "strand_byhash",
                "contig_offsets")
MAP_SUFFIXES = ("", ".meta", ".meta.unmappedReadsLengths")
MIN_READ_LEN = 2000
# four 25 kb genomes: two to a shard under this memory model budget
TWO_SHARDS = 300_000
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "metamaps_tpu_torch", "csrc")


def _params(cls, fasta):
    p = cls()
    p.ref_sequences = [fasta]
    p.reference_size = total_file_size(p.ref_sequences)
    p.min_read_length = MIN_READ_LEN
    return p.derive_window_size(window_size_given=False)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A four-genome database, reads from it (noisy, too short, alien) and
    each package's stored index over one shard and over two."""
    root = tmp_path_factory.mktemp("torch_mai")
    db = str(root / "DB")
    rng = np.random.default_rng(8)
    genomes, _, _ = make_mini_db(db, rng, n_genomes=4, genome_len=25000)
    reads = sample_reads(rng, genomes, 12, min_len=2500, max_len=6000,
                         sub=0.06)
    reads.append((random_genome(rng, 500), -1, 0, 1))  # too short
    reads.append((random_genome(rng, 4000), -1, 0, 1))  # alien
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)
    fasta = os.path.join(db, "DB.fa")
    index = {}
    for mm in (0, TWO_SHARDS):
        for pkg, mod, cls in (("jax", jindex, JaxParameters),
                              ("port", tindex, Parameters)):
            prefix = str(root / f"{pkg}_{mm}" / "DB")
            os.makedirs(os.path.dirname(prefix))
            p = _params(cls, fasta)
            p.index = prefix
            index[pkg, mm] = (prefix, mod.create_index(p, prefix, mm))
    return root, db, fq, index


def _read(path, prefix=None, by=None):
    with open(path) as f:
        text = f.read()
    return text.replace(prefix, by) if prefix else text


@pytest.mark.parametrize("mm", [0, TWO_SHARDS], ids=["one_shard",
                                                     "two_shards"])
def test_index_files_cross_both_ways(mini, mm):
    jprefix, jfiles = mini[3]["jax", mm]
    tprefix, tfiles = mini[3]["port", mm]
    assert len(tfiles) == len(jfiles) == (2 if mm else 1)
    assert tindex.load_index_manifest(tprefix) == tfiles
    assert jindex.load_index_manifest(tprefix) == tfiles
    for suffix in (".index", ".parameters"):
        assert (_read(tprefix + suffix, tprefix, jprefix)
                == _read(jprefix + suffix)), suffix
    for tf, jf in zip(tfiles, jfiles):
        assert tf.replace(tprefix, jprefix) == jf
        shards = [jindex.SketchShard.load(tf), jindex.SketchShard.load(jf),
                  tindex.SketchShard.load(tf), tindex.SketchShard.load(jf)]
        want = shards[1]
        for got in (shards[0], shards[2], shards[3]):
            assert got.contig_names == want.contig_names
            assert got.contig_lengths == want.contig_lengths
            assert got.freq_threshold == want.freq_threshold
            for name in SHARD_FIELDS:
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name), name)


def _map_against_index(cli, index_prefix, fq, out, engine, extra=()):
    assert cli(["mapAgainstIndex", "--index", index_prefix, "--query", fq,
                "--output", out, "--all", "--mapping-engine", engine,
                *extra]) == 0
    return out


@pytest.fixture(scope="module")
def jax_outputs(mini):
    """The JAX package's mapAgainstIndex (serial oracle) over its own index
    files and over the port's, for each shard count."""
    root, _, fq, index = mini
    outs = {}
    for mm in (0, TWO_SHARDS):
        for pkg in ("jax", "port"):
            outs[pkg, mm] = _map_against_index(
                jax_cli_main, index[pkg, mm][0], fq,
                str(root / f"jax_over_{pkg}_{mm}.mappings"), "oracle")
    return outs


def _assert_same_outputs(got, want):
    for suffix in MAP_SUFFIXES:
        assert _read(got + suffix) == _read(want + suffix), \
            f"{suffix or 'mappings'} differs"
    assert (_read(got + ".parameters", got, want)
            == _read(want + ".parameters")), ".parameters differs"


@pytest.mark.parametrize("engine", ["torch", "oracle"])
@pytest.mark.parametrize("mm", [0, TWO_SHARDS], ids=["one_shard",
                                                     "two_shards"])
def test_map_against_index_matches_jax(mini, jax_outputs, mm, engine, capfd):
    """The torch engine runs with --profile, which must change no byte and
    print each shard's phase seconds."""
    root, _, fq, index = mini
    want = jax_outputs["jax", mm]
    # the JAX package gives the same bytes over the port's index files
    assert _read(jax_outputs["port", mm]) == _read(want)
    stats = {}
    # the torch engine over either package's index files
    pkgs = ("port", "jax") if engine == "torch" else ("port",)
    for pkg in pkgs:
        got = _map_against_index(
            lambda a: port_cli_main(a, engine_stats=stats), index[pkg, mm][0],
            fq, str(root / f"port_{engine}_over_{pkg}_{mm}.mappings"),
            engine, ("--device", "cpu") + (
                ("--profile",) if engine == "torch" else ()))
        _assert_same_outputs(got, want)
    n_shards = (2 if mm else 1) * len(pkgs)
    assert len(stats["shard_load_s"]) == n_shards
    assert stats["reads_total"] == n_shards * 14
    n_profiled = capfd.readouterr().err.count("phase seconds")
    if engine == "torch":
        assert stats["oracle_fallbacks"] == 0 and stats["l2_candidates"] > 0
        assert n_profiled == n_shards
    else:
        assert n_profiled == 0
    # the per-shard files are gone after unify
    assert not [f for f in os.listdir(root) if re.search(r"mappings\.\d+$", f)]


def test_multishard_map_directly_matches_jax(mini):
    root, db, fq, _ = mini
    fasta = os.path.join(db, "DB.fa")
    outs = {}
    for pkg, cls, run in (
            ("jax", JaxParameters, jax_mapwrap.map_directly),
            ("port", Parameters,
             lambda p, mm: mapwrap.map_directly(p, mm, device="cpu"))):
        p = _params(cls, fasta)
        p.query_sequences = [fq]
        p.out_file_name = outs[pkg] = str(root / f"md_{pkg}.mappings")
        p.report_all = True
        p.engine = "oracle" if pkg == "jax" else "torch"
        run(p, TWO_SHARDS)
    _assert_same_outputs(outs["port"], outs["jax"])
    n_lines = len(_read(outs["jax"]).splitlines())
    assert n_lines >= 12


def test_map_against_index_requires_cuda(mini, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _, fq, index = mini
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli_main(["mapAgainstIndex", "--index", index["port", 0][0],
                       "--query", fq, "--output", str(root / "no_cuda")])


def test_minhits_table_once_per_process(mini, monkeypatch):
    """Every engine, one per shard and query file, reuses one host table,
    which grows to the largest sketch mapped, each size computed once."""
    _, db, _, index = mini
    p = _params(Parameters, os.path.join(db, "DB.fa"))
    shard = tindex.SketchShard.load(index["port", TWO_SHARDS][1][0])
    seqs = [s for _, s in read_sequences(os.path.join(db, "DB.fa"))]
    reads = [seqs[0][1000:4000], seqs[1][2000:7000]]
    monkeypatch.setattr(l1, "_MINHITS", {})
    calls = []
    relaxed = l1._relaxed_minhits
    monkeypatch.setattr(l1, "_relaxed_minhits",
                        lambda s, *a: calls.extend(s.tolist()) or relaxed(s, *a))
    for _ in range(3):
        engine = TorchMapperEngine(shard, p, device="cpu")
        engine.map_reads(reads)
    s_max = max(mapper_oracle.sketch_read(r, p.kmer_size, p.window_size)[0]
                .size for r in reads)
    assert sorted(calls) == list(range(1, s_max + 1))
    assert engine._minhits.numel() == s_max + 1
    table = l1.minhits_table(s_max, p.kmer_size, p.percentage_identity)
    assert not table.flags.writeable
    want = [l1.stats.estimate_minimum_hits_relaxed(s, p.kmer_size,
                                                   p.percentage_identity)
            for s in (1, s_max // 2, s_max)]
    assert [table[s] for s in (1, s_max // 2, s_max)] == want


@pytest.mark.parametrize("k,pi", [(16, 75.0), (16, 60.0), (15, 85.0)])
def test_minhits_table_equals_the_scalar(k, pi, monkeypatch):
    """The vectorised table against ``estimate_minimum_hits_relaxed`` at
    every size up to 1500 (in blocks of 512, so that a block starts
    mid-table) and at sizes up to the widest bucket's 41,088."""
    monkeypatch.setattr(l1, "_MINHITS", {})
    monkeypatch.setattr(l1, "_MINHITS_BLOCK", 512)
    table = l1.minhits_table(1500, k, pi)
    want = [l1.stats.estimate_minimum_hits_relaxed(s, k, pi)
            for s in range(1, 1501)]
    assert table[0] == 0 and table[1:].tolist() == want
    wide = np.random.default_rng(int(pi)).integers(1501, 41089, 8)
    assert l1._relaxed_minhits(wide, k, pi).tolist() == [
        l1.stats.estimate_minimum_hits_relaxed(int(s), k, pi) for s in wide]


def test_batch_sp_max_follows_the_kernel_source():
    """BATCH_SP_MAX is the widest plane that fits one warp's shared memory
    in csrc/l2_sweep.cu."""
    with open(os.path.join(CSRC, "l2_sweep.cu")) as f:
        src = f.read()
    with open(os.path.join(CSRC, "l2_sweep_common.cuh")) as f:
        common = f.read()
    tile = int(re.search(r"constexpr int TILE = (\d+);", common).group(1))
    per_block = int(re.search(r"SMEM_PER_BLOCK = (\d+);", src).group(1))
    body = re.search(r"long long warp_smem_bytes\(int sp\) \{\s*return "
                     r"\(2LL \* sp \+ 8LL \* TILE\) \* \(long long\)"
                     r"sizeof\(int\);\s*\}", src)
    assert body, "warp_smem_bytes changed: update BATCH_SP_MAX"
    assert tile == l2_sweep.TILE_EVENTS
    assert per_block == l2_sweep.SMEM_LIMIT

    def warp_bytes(sp):
        return (2 * sp + 8 * tile) * 4

    assert l2_sweep.BATCH_SP_MAX == 28800
    assert warp_bytes(l2_sweep.BATCH_SP_MAX) <= per_block
    assert warp_bytes(l2_sweep.BATCH_SP_MAX + 128) > per_block


def test_wide_planes_go_to_the_wide_sweep(mini, monkeypatch):
    """With BATCH_SP_MAX lowered between the slabs' plane widths, the batch
    sweep hands the wider slabs to the wide sweep, on the CPU as on the
    card; no read goes to the oracle for it, and every read gets the
    oracle's lines."""
    _, db, fq, index = mini
    p = _params(Parameters, os.path.join(db, "DB.fa"))
    p.report_all = True
    shard = tindex.SketchShard.load(index["port", 0][1][0])
    seqs = [s for _, s in read_sequences(fq) if len(s) >= MIN_READ_LEN]
    calls = {"batch": [], "wide": []}
    for name in calls:
        fn = getattr(l2_sweep, f"l2_event_sweep_{name}")
        monkeypatch.setattr(
            l2_sweep, f"l2_event_sweep_{name}",
            lambda *a, fn=fn, name=name: calls[name].append(a[4]) or fn(*a))
    monkeypatch.setattr(l2_ops, "l2_event_sweep_batch",
                        l2_sweep.l2_event_sweep_batch)
    TorchMapperEngine(shard, p, device="cpu").map_reads(seqs)
    widths = sorted(set(calls["batch"]))
    assert len(widths) >= 2 and not calls["wide"]
    limit = widths[0]
    monkeypatch.setattr(l2_sweep, "BATCH_SP_MAX", limit)
    calls["batch"].clear()
    engine = TorchMapperEngine(shard, p, device="cpu")
    got = engine.map_reads(seqs)
    assert calls["wide"] == [sp for sp in calls["batch"] if sp > limit]
    assert calls["wide"] and len(calls["wide"]) < len(calls["batch"])
    assert engine.stats["oracle_fallbacks"] == 0
    for seq, maps in zip(seqs, got):
        assert maps == mapper_oracle.map_read(shard, p, seq)


def test_oracle_shared_count_equals_jax_oracle():
    """The port's oracle counts shared hashes by union ranks; the JAX
    package's sorts the union. Random windows, with and without common
    hashes, s below, at and above |Q|."""
    rng = np.random.default_rng(5)
    for t in range(2000):
        hi = int(rng.integers(4, 3000))
        q = np.unique(rng.integers(0, hi, int(rng.integers(1, 400)))
                      .astype(np.uint32))
        r = rng.integers(0, hi, int(rng.integers(0, 500))).astype(np.uint32)
        s = q.size if t % 4 == 0 else int(rng.integers(1, q.size + 8))
        assert (mapper_oracle._shared_sketch_count(q, None, r, s)
                == jax_oracle._shared_sketch_count(q, None, r, s)), t
