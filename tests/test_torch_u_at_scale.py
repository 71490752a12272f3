"""``metamaps_tpu_torch/profiling/u_at_scale.py`` and ``u_mapq_scale.py``
against the repo's JAX scripts of the same names and the JAX package, on
the CPU.

- the database directory: the port's ``build_db_dir`` on the bench's
  genomes at 2 Mbp writes the bytes of the JAX script's ``build_db_dir``
  (loaded by path, its ``DB_DIR`` and its ``synth_structured_db`` patched
  to a temporary directory and 2 Mbp; nothing of the JAX package edited);
- the chain, at 15 Mbp of the bench's database (at 1-2 Mbp most reads go
  to the serial oracle, see ``tests/test_torch_bench.py``): 32 of the
  bench's reads mapped by the port's engine on the CPU and dumped with
  ``bench.dump_mappings``; the JAX side runs its CLI's ``classify``, then
  ``metamaps_tpu.db.self_similarity``'s ``prepare``, ``run_job`` on the
  two jobs with the fewest B bases (one chunk length, 4 chunks) and
  ``collect``, then ``classifyU``; the port runs ``main(["--device",
  "cpu", "--jobs", ...])`` with the same reduced workload in a second
  directory. ``--minreads 5`` keeps several taxa in ``classify`` (checked).
  Every file of the two directories (the database, ``.EM*``,
  ``jobs.json``, ``results/*.json``, ``selfSimilarities.txt``, ``.U*``)
  must be byte-identical;
- ``--workers 2`` writes the files of the serial run, and records each
  job's peak resident bytes (the serial run records none);
- ``identity_floor``, the lowest histogram identity the acceptance rule
  admits, equals the lowest over every sketch size of the JAX package's
  scalar relaxed minimum hits; ``job_checks`` flags an identity below it,
  one above 100 and a histogram that counts more chunks than were drawn;
- the port's default ``SIM_KW`` is the JAX script's; ``main`` raises
  without CUDA unless ``--device cpu`` is passed;
- ``u_mapq_scale``: its synthetic identity manager equals the JAX test
  helper's field by field; at 500 reads its ``main`` finds its vectorised
  and scalar mapping qualities in agreement, and its reads and vectorised
  mapping qualities equal the JAX script's reads through the JAX
  package's, within 1e-12 absolute plus 1e-9 relative.
"""
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.db import self_similarity as jax_ss
from metamaps_tpu import stats as jax_stats
from metamaps_tpu.engine import u as jax_u
from metamaps_tpu.sim import synth_db as jax_synth_db
from metamaps_tpu_torch.engine import u
from metamaps_tpu_torch.profiling import bench
from metamaps_tpu_torch.profiling import u_at_scale as ua
from metamaps_tpu_torch.profiling import u_mapq_scale as umq

from test_u_pipeline import _synthetic_identity_manager as jax_identity_manager
from util_torch import (assert_same_trees, one_torch_thread,  # noqa: F401
                        run_in, tree_bytes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_BASES = 2_000_000
MAP_BASES = 15_000_000
N_READS = 32
MIN_READS = "5"
N_JOBS = 2
SIM_KW = dict(sim_from=2000, sim_to=2000, sim_step=4000, max_chunks=4)
MAPPINGS = "bench_mappings.txt"
U_FILES = (".mapQ_U", ".U.WIMP", ".U.WIMP.absoluteClassifiedAt",
           ".U.reads2Taxon", ".U.lengthAndIdentitiesPerTaxonID",
           ".U.shiftedHistogramsPerTaxonID", ".EM2U.details",
           ".EM2U.summary")
MAPQ_READS = 500


def load_script(name: str):
    """A JAX script of ``profiling/`` as a module (it imports JAX only in
    ``main``)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "profiling", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched_synth(bases: int):
    real = jax_synth_db.synth_structured_db
    return lambda rng, total_bases: real(rng, total_bases=bases)


def test_db_dir_equals_the_jax_script(tmp_path, monkeypatch):
    jax_script = load_script("u_at_scale")
    want = tmp_path / "jax"
    monkeypatch.setattr(jax_script, "DB_DIR", str(want))
    monkeypatch.setattr(jax_synth_db, "synth_structured_db",
                        patched_synth(DATA_BASES))
    jax_bases = jax_script.build_db_dir()
    _, genomes, names = bench.synth_genomes(DATA_BASES, bench.LARGE_SEED)
    got = tmp_path / "port"
    assert ua.build_db_dir(str(got), genomes, names) == jax_bases
    assert jax_bases >= DATA_BASES * 0.9
    assert sorted(tree_bytes(str(got))) == [
        "DB.fa", "contigNstats_windowSize_1000.txt", "taxonInfo.txt",
        os.path.join("taxonomy", "merged.dmp"),
        os.path.join("taxonomy", "names.dmp"),
        os.path.join("taxonomy", "nodes.dmp")]
    assert_same_trees(str(want), str(got))
    with open(got / "taxonomy" / "nodes.dmp") as f:
        assert sum(line.startswith("x20") for line in f) == 3


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The JAX side and the port, serial and with two workers, each in its
    own directory with the same relative paths."""
    root = tmp_path_factory.mktemp("u_at_scale")
    rng, genomes, names = bench.synth_genomes(MAP_BASES, bench.LARGE_SEED)
    reads = bench.draw_reads(rng, genomes, N_READS)
    params = bench.bench_params()
    shard = bench.build_shard(genomes, names, params, {})
    engine = bench.make_engine(shard, params, torch.device("cpu"))
    results = engine.map_reads(reads)
    assert engine.stats["oracle_fallbacks"] == 0
    merged, n_mapped = bench.unify_lines(params, [results], [shard],
                                         len(reads))
    assert n_mapped == N_READS
    dirs = {side: str(root / side) for side in ("jax", "port", "workers")}
    for d in dirs.values():
        os.makedirs(d)
        bench.dump_mappings(os.path.join(d, MAPPINGS), merged, reads, params,
                            int(sum(shard.contig_lengths)))

    jax_script = load_script("u_at_scale")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOURCE_DATE_EPOCH", "0")
        mp.setattr(jax_script, "DB_DIR", os.path.join(dirs["jax"], "DB"))
        mp.setattr(jax_synth_db, "synth_structured_db",
                   patched_synth(MAP_BASES))
        jax_script.build_db_dir()
        mp.chdir(dirs["jax"])
        minreads = ["--minreads", MIN_READS]
        assert jax_cli_main(["classify", "--mappings", MAPPINGS, "--DB",
                             "DB", *minreads]) in (0, None)
        out_dir = os.path.join("DB", "selfSimilarity")
        jobs = jax_ss.prepare("DB", out_dir)
        todo = ua.fewest_b_jobs("DB", jobs, N_JOBS)
        for i in todo:
            jax_ss.run_job("DB", jobs[i], out_dir, i, **SIM_KW)
        jax_ss.collect("DB", out_dir)
        assert jax_cli_main(["classifyU", "--mappings", MAPPINGS, "--DB",
                             "DB", *minreads]) in (0, None)
        mp.chdir(root)

        mp.setattr(ua, "SIM_KW", dict(SIM_KW))
        mp.setattr(ua, "DB_BASES", MAP_BASES)
        argv = ["--device", "cpu", "--mappings", MAPPINGS, "--db-dir", "DB",
                "--minreads", MIN_READS,
                "--jobs", ",".join(map(str, todo))]
        records = {}
        for side, extra in (("port", []),
                            ("workers", ["--workers", "2", "--no-split"])):
            out = str(root / f"{side}_record" / "record.json")
            assert run_in(dirs[side], ua.main, argv + extra + ["--out", out]
                          ) == 0
            with open(out) as f:
                records[side] = json.load(f)
    return dirs, todo, records


def test_chosen_jobs_have_the_fewest_b_bases(chain):
    dirs, todo, records = chain
    db = os.path.join(dirs["jax"], "DB")
    jobs = jax_ss.load_jobs(os.path.join(db, "selfSimilarity"))
    sizes = {}
    with open(os.path.join(db, "taxonInfo.txt")) as f:
        for line in f:
            tax, rest = line.split(" ", 1)
            sizes[tax] = sizes.get(tax, 0) + int(rest.rsplit("=", 1)[1])
    b = [sum(sizes[t] for t in job.b_taxa) for job in jobs]
    assert records["port"]["selfsim_job_b_bases"] == b
    assert len(todo) == N_JOBS
    assert max(b[i] for i in todo) <= min(
        b[i] for i in range(len(jobs)) if i not in todo)


@pytest.mark.parametrize("part", ["em", "jobs", "results", "selfsim", "u",
                                  "tree"])
def test_chain_equals_the_jax_side(chain, part):
    dirs, todo, _ = chain
    want, got = tree_bytes(dirs["jax"]), tree_bytes(dirs["port"])
    ss_dir = os.path.join("DB", "selfSimilarity")
    names = {
        "em": [MAPPINGS + s for s in ua.EM_FILES],
        "jobs": [os.path.join(ss_dir, "jobs.json")],
        "results": [os.path.join(ss_dir, "results", f"{i}{s}")
                    for i in todo for s in (".json", ".reads.json")],
        "selfsim": [os.path.join("DB", "selfSimilarities.txt"),
                    os.path.join("DB", "selfSimilarities.txt"
                                 ".expectedGenomeSizes")],
        "u": [MAPPINGS + s for s in U_FILES],
    }
    if part == "tree":
        assert_same_trees(dirs["jax"], dirs["port"])
        return
    for name in names[part]:
        assert want[name], f"{name} is empty"
        assert got[name] == want[name], name


def test_classify_keeps_several_taxa(chain):
    dirs, _, _ = chain
    with open(os.path.join(dirs["port"], MAPPINGS + ".EM.WIMP")) as f:
        rows = [line.split("\t") for line in f][1:]
    species = [r for r in rows if r[0] == "definedGenomes" and int(r[3]) > 0]
    assert len(species) >= 2


def test_workers_write_the_serial_files(chain):
    dirs, todo, records = chain
    assert_same_trees(dirs["port"], dirs["workers"])
    rec = records["workers"]
    assert rec["selfsim_workers"] == 2 and rec["selfsim_jobs_run"] == todo
    assert "selfsim_job_split" not in rec
    assert all(0 < b <= a for a, b in zip(
        rec["selfsim_job_peak_rss_bytes"],
        rec["selfsim_job_peak_rss_before_bytes"], strict=True))


def test_record(chain):
    dirs, todo, records = chain
    jax_keys = {"artifact", "date", "mappings", "mapping_lines",
                "db_bases", "db_build_s", "classify_s", "em_wimp_rows",
                "selfsim_jobs_total", "selfsim_params", "selfsim_jobs_done",
                "selfsim_job_s", "selfsim_total_s", "selfsim_lines",
                "classifyU_s", "u_wimp_rows", "u_reads2taxon_rows"}
    rec = records["port"]
    assert jax_keys <= set(rec)
    assert rec["card"] is None and rec["em_device"] == "cpu"
    assert rec["em_equal_numpy"] == {s: True for s in ua.EM_FILES}
    assert rec["selfsim_jobs_total"] == 30
    assert rec["selfsim_jobs_done"] == N_JOBS
    assert rec["selfsim_jobs_run"] == todo
    assert len(rec["selfsim_job_s"]) == N_JOBS
    # the serial run's jobs ran in this process, whose peak is not theirs
    assert rec["selfsim_job_peak_rss_bytes"] == [None] * N_JOBS
    assert rec["selfsim_job_peak_rss_before_bytes"] == [None] * N_JOBS
    assert rec["selfsim_params"] == SIM_KW
    assert rec["selfsim_reduced"] == (
        "chunk lengths 2000..2000 step 4000, at most 4 chunks a length "
        "(reference: 2000..50000 step 1000, at most 2000)")
    assert rec["selfsim_check_failures"] == []
    assert rec["u_reads2taxon_rows"] == N_READS
    with open(os.path.join(dirs["port"], MAPPINGS)) as f:
        assert rec["mapping_lines"] == sum(1 for _ in f)
    split = rec["selfsim_job_split"]
    assert split["job"] in todo
    parts = [split[k] for k in ua.SPLIT]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= split["profiled_s"]
    # nothing of the run is left beside the record
    assert os.listdir(os.path.join(os.path.dirname(dirs["port"]),
                                   "port_record")) == ["record.json"]


def test_job_checks_flag_an_overcount_and_an_identity_past_100(chain,
                                                               tmp_path):
    dirs, todo, _ = chain
    out_dir = str(tmp_path / "selfSimilarity")
    shutil.copytree(os.path.join(dirs["port"], "DB", "selfSimilarity"),
                    out_dir)
    assert ua.job_checks(out_dir, todo) == []
    fn = os.path.join(out_dir, "results", f"{todo[0]}.json")
    with open(fn) as f:
        hist = json.load(f)
    with open(os.path.join(out_dir, "results", f"{todo[0]}.reads.json")) as f:
        chunks = json.load(f)["chunks"]
    length = next(iter(hist))
    drawn = sum(c[0] == int(length) for c in chunks)
    hist[length] = {"101": 1, "90": drawn}  # one more than drawn, one > 100
    with open(fn, "w") as f:
        json.dump(hist, f)
    failures = ua.job_checks(out_dir, todo + [99])
    assert len(failures) == 3
    assert "no result" in failures[-1]


def test_identity_floor_is_the_acceptance_rule_s_lowest():
    length = SIM_KW["sim_from"]
    lowest = min(
        (float(np.float32(100 * (1 - np.float32(jax_stats.j2md(
            np.float32(1.0) * hits / s, ua.SIM_K))))), s)
        for s in range(1, length - ua.SIM_K + 2)
        for hits in [jax_stats.estimate_minimum_hits_relaxed(
            s, ua.SIM_K, ua.SIM_PI)])
    assert ua.identity_floor(length) == int(lowest[0] + 0.5) == 73
    assert lowest[1] == 144


def test_job_checks_flag_an_identity_below_the_floor(chain, tmp_path):
    dirs, todo, _ = chain
    out_dir = str(tmp_path / "selfSimilarity")
    shutil.copytree(os.path.join(dirs["port"], "DB", "selfSimilarity"),
                    out_dir)
    fn = os.path.join(out_dir, "results", f"{todo[0]}.json")
    with open(fn) as f:
        hist = json.load(f)
    length = next(iter(hist))
    floor = ua.identity_floor(int(length))
    hist[length] = {str(floor): 1}
    with open(fn, "w") as f:
        json.dump(hist, f)
    assert ua.job_checks(out_dir, todo) == []
    hist[length] = {str(floor - 1): 1}
    with open(fn, "w") as f:
        json.dump(hist, f)
    assert ua.job_checks(out_dir, todo) == [
        f"job {todo[0]}: identities ['{floor - 1}'] at {length}"]


def test_default_sim_kw_equals_the_jax_script():
    jax_script = load_script("u_at_scale")
    assert ua.SIM_KW == jax_script.SIM_KW
    assert ua.BUDGET_S == 5400 and ua.MIN_READS == 100


def test_main_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ua.main(["--mappings", str(tmp_path / "m"), "--db-dir",
                 str(tmp_path / "DB"), "--out", str(tmp_path / "r.json")])
    assert os.listdir(tmp_path) == []


def test_synthetic_identity_manager_equals_the_test_helper():
    want, got = jax_identity_manager(), umq._synthetic_identity_manager()
    for f in ("minimum_identity", "maximum_identity", "identity_histogram",
              "read_length_histogram"):
        assert getattr(got.ih, f) == getattr(want.ih, f), f
    assert got.tai.D == want.tai.D
    assert vars(got).keys() == vars(want).keys()
    for f, v in vars(want).items():
        if f not in ("ih", "tai"):
            assert vars(got)[f] == v, f


def test_u_mapq_scale_agrees_with_its_scalar_and_the_jax_package(capsys):
    assert umq.main([str(MAPQ_READS)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].startswith("scalar oracle :")
    assert lines[2].startswith("vectorized    :")
    assert lines[3].startswith("speedup       :")
    rec = json.loads(lines[-1])
    assert rec["agree"] and rec["scalar_reads"] == MAPQ_READS
    assert rec["mapping_lines"] == 5 * MAPQ_READS and rec["card"] is None

    jax_script = load_script("u_mapq_scale")
    reads = umq.make_reads(MAPQ_READS, np.random.default_rng(umq.SEED))
    jax_reads = jax_script.make_reads(MAPQ_READS,
                                      np.random.default_rng(umq.SEED))
    im, jim = umq._synthetic_identity_manager(), jax_identity_manager()
    for locs, jlocs in zip(reads, jax_reads, strict=True):
        assert [vars(a) for a in locs] == [vars(b) for b in jlocs]
        u.compute_u_mapping_qualities(locs, im, umq.K)
        jax_u.compute_u_mapping_qualities(jlocs, jim, umq.K)
    worst, agree = umq.max_disagreement(jax_reads, reads)
    assert agree, worst
