"""The port's bench (``metamaps_tpu_torch/profiling/bench.py``) against the
repo's root ``bench.py`` and the JAX package, on the CPU.

- data: the bench's genomes and reads are root ``bench.py``'s recipe run
  through ``metamaps_tpu.sim.synth_db``; its shard equals the JAX
  package's ``SketchShard.finalize`` on those genomes and the shard the
  port's ``index`` stores from the same ``DB.fa`` at ``--window 16 --pi
  80 --minReadLen 2000``, and its cached index restores the same shard and
  sketch parameters;
- the union: ``unify_lines`` equals root ``bench.unify_lines`` on the same
  JAX-oracle results (host code only: no JAX compile);
- the engine's ``hits_max`` override maps a read whose hits lie between a
  bucket's capacity and the override on the engine, with the JAX
  package's oracle's lines; without it the read goes to the oracle;
- the real-distribution EM table keeps every block's per-read lines, and
  its round on the CPU agrees with ``em_iterate``;
- a corrupt cache is a miss and is rebuilt;
- ``main --quick --device cpu`` prints the JSON line with every key, and
  raises without CUDA unless the CPU is asked for;
- the two-shard union equals the serial oracle's over the same shards
  through ``unify_files``, and the JAX package's oracle's through root
  ``bench.unify_lines``;
- every thread of the bench's winnowing pool gets the native winnower,
  the ones that arrive while it is being built too.

The data tests run at 2 Mbp. The mapping tests run at 15 Mbp: at 1-2 Mbp
the recipe's 40 homologous 20 kb segments fill most of each ~100 kb
genome, and most reads exceed the engine's region caps and go to the
serial oracle (seconds each on a CPU); at 15 Mbp none does.
"""
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from metamaps_tpu.engine import index as jindex
from metamaps_tpu.engine import mapper_oracle as jax_oracle
from metamaps_tpu.ops.winnow import winnow_fast as jax_winnow_fast
from metamaps_tpu.params import Parameters as JaxParameters
from metamaps_tpu.sim import synth_db as jax_synth
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.engine import index as tindex
from metamaps_tpu_torch.engine import mapper_oracle, mapwrap
from metamaps_tpu_torch.engine.em import load_mapping_table
from metamaps_tpu_torch.io import native
from metamaps_tpu_torch.io.mappings import MappingLine, read_parameters_file
from metamaps_tpu_torch.params import Parameters
from metamaps_tpu_torch.profiling import bench
from metamaps_tpu_torch.sim.synth_db import BASES, mutate_sub
from metamaps_tpu_torch.taxonomy import extract_taxon_id

from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as root_bench  # noqa: E402

SHARD_FIELDS = ("seqid", "wpos", "strand", "hash_pos_order", "hash_sorted",
                "seqid_byhash", "wpos_byhash", "strand_byhash",
                "contig_offsets")
SKETCH_KEYS = ("kmerSize", "windowSize", "minReadLength", "alphabetSize",
               "percentageIdentity")
DATA_BASES = 2_000_000
MAP_BASES = 15_000_000
CPU = torch.device("cpu")


def assert_same_shard(a, b):
    assert list(a.contig_names) == list(b.contig_names)
    assert [int(x) for x in a.contig_lengths] == \
        [int(x) for x in b.contig_lengths]
    assert int(a.freq_threshold) == int(b.freq_threshold)
    for f in SHARD_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def jax_params():
    return JaxParameters(kmer_size=16, window_size=16, min_read_length=2000,
                         percentage_identity=80.0, report_all=True)


def jax_shard(genomes, names):
    """The JAX package's shard of ``genomes`` (one contig each)."""
    shard = jindex.SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        h, p, s = jax_winnow_fast(g, 16, 16)
        parts.append((h, p, s, i))
        shard.contig_names.append(names[i])
        shard.contig_lengths.append(len(g))
    return shard.finalize(parts)


def mapping_lines(maps, shard):
    return [MappingLine(
        read_id="r", read_len=m.query_len, strand=m.strand,
        contig_id=shard.contig_names[m.ref_seqid],
        contig_len=shard.contig_lengths[m.ref_seqid],
        ref_start=m.ref_start, ref_end=m.ref_end, identity=m.nuc_identity,
        intersection=m.conserved, sketch_size=m.sketch_size).format()
        for m in maps]


@pytest.fixture(scope="module")
def mapped():
    """The bench's database at 15 Mbp, 8 of its reads and its shard."""
    rng, genomes, names = bench.synth_genomes(MAP_BASES, bench.LARGE_SEED)
    reads = bench.draw_reads(rng, genomes, 8)
    shard = bench.build_shard(genomes, names, bench.bench_params(), {})
    return SimpleNamespace(genomes=genomes, names=names, reads=reads,
                           shard=shard)


def test_data_and_shard_equal_the_jax_recipe_and_the_index(tmp_path):
    rng, genomes, names = bench.synth_genomes(DATA_BASES, bench.LARGE_SEED)
    reads = bench.draw_reads(rng, genomes, 40)
    jrng = np.random.default_rng(root_bench.LARGE_SEED)
    jg, jn = jax_synth.synth_structured_db(jrng, total_bases=DATA_BASES)
    jr = [r[:8192] for r in jax_synth.make_ont_reads(
        jrng, jg, 40, min_len=3000, max_len=7600)]
    assert names == jn and len(genomes) == len(jg) == 15
    for a, b in zip(genomes, jg):
        np.testing.assert_array_equal(a, b)
    assert len(reads) == len(jr)
    for a, b in zip(reads, jr):
        np.testing.assert_array_equal(a, b)

    params = bench.bench_params()
    shard = bench.build_shard(genomes, names, params, {})
    assert shard.freq_threshold < tindex.INT_MAX  # the threshold binds
    assert_same_shard(shard, jax_shard(jg, jn))

    db_fa = str(tmp_path / "DB.fa")
    bench.write_db_fasta(db_fa, genomes, names)
    prefix = str(tmp_path / "idx")
    assert port_cli_main(["index", "--reference", db_fa, "--index", prefix,
                          "--window", "16", "--pi", "80", "--minReadLen",
                          "2000"]) == 0
    (stored,) = tindex.load_index_manifest(prefix)
    assert_same_shard(shard, tindex.SketchShard.load(stored))

    # the cache's stored index: the same shard and sketch parameters
    cache = bench.cache_prefix(str(tmp_path / "cache"), DATA_BASES, 1)
    bench.save_index(cache, shard, params, DATA_BASES, 1)
    assert_same_shard(shard, bench.load_index(cache, DATA_BASES, 1))
    want, got = read_parameters_file(prefix), read_parameters_file(cache)
    assert {k: got[k] for k in SKETCH_KEYS} == {k: want[k] for k in SKETCH_KEYS}


def test_unify_lines_equals_the_root_bench(mapped):
    jshard = jax_shard(mapped.genomes, mapped.names)
    results = [jax_oracle.map_read(jshard, jax_params(), r)
               for r in mapped.reads]
    # the same shard twice: mapping qualities over a two-shard union
    want, want_n = root_bench.unify_lines(jax_params(), [results, results],
                                          [jshard, jshard], len(results))
    got, got_n = bench.unify_lines(bench.bench_params(), [results, results],
                                   [mapped.shard, mapped.shard], len(results))
    assert want and got == want and got_n == want_n == len(results)


def test_hits_max_override_maps_a_read_between_the_caps():
    """12 copies of a 60 kb genome at 1 % divergence: a 3000 bp read of it
    has ~12 hits per minimizer, past the 3072 bucket's capacity."""
    rng = np.random.default_rng(5)
    base = BASES[rng.integers(0, 4, 60_000)]
    genomes = [base] + [mutate_sub(rng, base, 0.01) for _ in range(11)]
    names = [f"G{i}|kraken:taxid|{100 + i}|chr" for i in range(12)]
    params = bench.bench_params()
    shard = bench.build_shard(genomes, names, params, {}, threads=2)
    read = mutate_sub(rng, base[10_000:13_000], 0.02)
    hashes = mapper_oracle.sketch_read(read, 16, 16)[0]
    total = int(shard.lookup_counts(hashes)[1].sum())

    plain = bench.TorchMapperEngine(shard, params, device="cpu",
                                    read_len_buckets=bench.BENCH_BUCKETS)
    cap = plain._config_for(3072).hits_max
    assert cap < total <= bench.HITS_MAX, (cap, total)
    jshard = jax_shard(genomes, names)
    want = mapping_lines(jax_oracle.map_read(jshard, jax_params(), read),
                         jshard)
    assert len(want) == 12
    assert mapping_lines(mapper_oracle.map_read(shard, params, read),
                         shard) == want

    engine = bench.make_engine(shard, params, CPU)
    assert engine._config_for(3072).hits_max == bench.HITS_MAX
    got = engine.map_reads([read])[0]
    assert engine.stats["oracle_fallbacks"] == 0
    assert engine.stats["l2_candidates"] == 12
    assert mapping_lines(got, shard) == want

    assert mapping_lines(plain.map_reads([read])[0], shard) == want
    assert plain.stats["oracle_fallbacks"] == 1


def test_realdist_table_keeps_each_block_and_agrees_with_the_host(
        mapped, tmp_path, monkeypatch):
    params = bench.bench_params()
    results = [mapper_oracle.map_read(mapped.shard, params, r)
               for r in mapped.reads]
    merged, _ = bench.unify_lines(params, [results], [mapped.shard],
                                  len(results))
    taxon_info: dict = {}
    for name, length in zip(mapped.shard.contig_names,
                            mapped.shard.contig_lengths):
        taxon_info.setdefault(extract_taxon_id(name), {})[name] = length
    fn = str(tmp_path / "mappings")
    with open(fn, "w") as f:
        f.write("\n".join(merged) + "\n")
    base = load_mapping_table(fn, taxon_info)
    n0, r0, t0 = len(base.mapq), len(base.read_ids), len(base.taxon_list)

    tiled = bench.tile_table(base, 10 * n0 + 1, 3 * t0)
    k, t_rep = 11, 3
    assert len(tiled.mapq) == k * n0 and len(tiled.read_ids) == k * r0
    assert len(tiled.taxon_list) == t_rep * t0
    for j in range(k):
        block = slice(j * n0, (j + 1) * n0)
        np.testing.assert_array_equal(tiled.read_of_line[block],
                                      base.read_of_line + j * r0)
        np.testing.assert_array_equal(tiled.taxon_of_line[block],
                                      base.taxon_of_line + (j % t_rep) * t0)
        for f in ("mapq", "inv_locations", "identity", "start", "stop",
                  "read_len"):
            np.testing.assert_array_equal(getattr(tiled, f)[block],
                                          getattr(base, f))
    names = [tiled.taxon_list[i] for i in tiled.taxon_of_line[block]]
    assert names == [f"{base.taxon_list[i]}.{(k - 1) % t_rep}"
                     for i in base.taxon_of_line]

    monkeypatch.setattr(bench, "EM_REALDIST_LINES", 20_000)
    row = bench.em_bench_realdist(merged, [mapped.shard], CPU)
    assert row["em_lines_base"] == n0
    assert row["em_lines_realdist"] >= 20_000
    assert row["em_taxa_realdist"] >= bench.EM_REALDIST_TAXA
    assert row["em_ll_rel_diff_realdist"] <= 1e-12
    assert row["em_f_max_abs_diff_realdist"] <= 1e-12


def test_corrupt_cache_is_rebuilt(tmp_path):
    cache = str(tmp_path)
    seed = bench.LARGE_SEED
    shard, reads, info = bench.build_db_large(DATA_BASES, 8, seed, cache)
    assert info["cache"] == "miss" and "synth_s" in info
    again, reads2, info2 = bench.build_db_large(DATA_BASES, 8, seed, cache)
    assert info2["cache"] == "hit" and "synth_s" not in info2
    assert_same_shard(shard, again)
    assert all(np.array_equal(a, b) for a, b in zip(reads, reads2))
    # fewer reads: the first of the cached set, without synthesis
    _, four, info4 = bench.build_db_large(DATA_BASES, 4, seed, cache)
    assert "synth_s" not in info4
    assert all(np.array_equal(a, b) for a, b in zip(reads[:4], four))

    npz = bench.cache_prefix(cache, DATA_BASES, seed) + ".1.npz"
    with open(npz, "r+b") as f:
        f.truncate(100)
    rebuilt, _, info3 = bench.build_db_large(DATA_BASES, 8, seed, cache)
    assert info3["cache"] == "miss"
    assert_same_shard(shard, rebuilt)
    assert bench.build_db_large(DATA_BASES, 8, seed, cache)[2]["cache"] == "hit"

    reads_npz = os.path.join(cache, f"reads_{DATA_BASES}_{seed}_8.npz")
    with open(reads_npz, "wb") as f:
        f.write(b"not an npz")
    _, redrawn, info5 = bench.build_db_large(DATA_BASES, 8, seed, cache)
    assert info5["cache"] == "hit" and "reads_s" in info5
    assert all(np.array_equal(a, b) for a, b in zip(reads, redrawn))


DETAIL_KEYS = (
    "mode", "db_bases", "n_minimizers", "freq_threshold", "upload_s",
    "device_table_gb", "bytes_per_minimizer", "oracle_fallbacks",
    "l2_slabs", "l2_candidates", "sweep_launches", "n_reads", "n_mapped",
    "mean_mappings_per_read", "map_s", "map_s_passes", "map_s_min",
    "map_s_max", "reads_per_s_best", "peak_device_bytes", "device", "card",
    "em_iter_ms_1Mlines", "em_host_round_ms_1Mlines", "unify_s",
    "em_iter_ms_realdist", "em_host_round_ms_realdist",
    "em_lines_realdist", "em_taxa_realdist")


def test_main_quick_prints_the_json_line_with_every_key(capsys, monkeypatch):
    monkeypatch.setattr(bench, "EM_SYNTH_LINES", 20_000)
    monkeypatch.setattr(bench, "EM_REALDIST_LINES", 40_000)
    assert bench.main(["--quick", "--device", "cpu", "--reads", "64"]) == 0
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert len(out) == 2  # after the mapping passes, and after the EM
    first, last = out
    for row in out:
        assert row["metric"] == "mapping_throughput"
        assert row["unit"] == "reads/s/card"
    assert "em_iter_ms_1Mlines" not in first["detail"]
    detail = last["detail"]
    assert [k for k in DETAIL_KEYS if k not in detail] == []
    assert "hbm_gb" not in detail and "lookup_mode" not in detail
    assert detail["mode"] == "quick" and detail["n_reads"] == 64
    assert detail["device"] == "cpu" and detail["card"] is None
    assert detail["peak_device_bytes"] is None
    assert detail["n_mapped"] == 64 and detail["oracle_fallbacks"] == 0
    assert len(detail["map_s_passes"]) == 3
    assert last["value"] == pytest.approx(64 / detail["map_s"])


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--quick", "--reads", "8"])


def test_multishard_union_equals_the_oracle_through_unify_files(tmp_path):
    cache = str(tmp_path / "cache")
    detail, merged, meta, reads = bench.run_multishard_bench(
        2, 8, MAP_BASES, "cpu", cache)
    assert detail["n_reads"] == 8 and detail["n_shards"] == 2
    assert detail["oracle_fallbacks"] == (detail["shard0_fallbacks"]
                                          + detail["shard1_fallbacks"])
    assert [m.contig_names[0].split("|")[0] for m in meta] == ["s0", "s1"]

    params = bench.bench_params()
    fq = str(tmp_path / "reads.fastq")
    bench.write_fastq(fq, reads)
    outs = []
    for i in range(2):
        prefix = bench.cache_prefix(cache, MAP_BASES, bench.shard_seed(i))
        shard = tindex.SketchShard.load(tindex.load_index_manifest(prefix)[0])
        shard.contig_names = [f"s{i}|{n}" for n in shard.contig_names]
        outs.append(str(tmp_path / f"oracle.{i}"))
        mapwrap.map_query_file_against_shard(shard, params, fq, outs[-1],
                                             engine="oracle")
    out = str(tmp_path / "oracle")
    p = Parameters(**{**params.__dict__})
    p.query_sequences, p.out_file_name = [fq], out
    mapwrap.unify_files(out, p, outs, [fq])
    with open(out) as f:
        assert f.read().splitlines() == merged
    assert merged

    # the JAX package's oracle on the same databases, through root
    # bench.unify_lines
    jshards, jresults = [], []
    for i in range(2):
        _, genomes, names = bench.synth_genomes(MAP_BASES,
                                                bench.shard_seed(i))
        jshards.append(jax_shard(genomes, [f"s{i}|{n}" for n in names]))
        jresults.append([jax_oracle.map_read(jshards[-1], jax_params(), r)
                         for r in reads])
    want, want_n = root_bench.unify_lines(jax_params(), jresults, jshards,
                                          len(reads))
    assert merged == want and detail["n_mapped"] == want_n


def test_winnowing_threads_wait_for_the_native_build(monkeypatch):
    """Threads that asked while the first one built the library got None
    and winnowed in numpy (65 s against 8 s for the 1 Gbp build)."""
    real = native._compile

    def slow_compile(*args, **kwargs):
        time.sleep(0.5)
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "_compile", slow_compile)
    monkeypatch.setattr(native, "_WINNOW_LIB", None)
    monkeypatch.setattr(native, "_WINNOW_TRIED", False)
    seq = BASES[np.random.default_rng(3).integers(0, 4, 5000)]
    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda _: native.winnow_native(seq, 16, 16),
                           range(8)))
    assert all(out is not None for out in outs)
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            np.testing.assert_array_equal(a, b)
