"""The port's spans (``metamaps_tpu_torch/trace.py``) on the CPU at a tiny
size: how the per-file path and the engine nest them, the engine's phase
seconds taken from them, their ``metamaps.*`` annotations under an active
``torch.profiler`` (and none without one), and the benchmark's readers of
them (``portbench/metrics/``)."""
import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from metamaps_tpu_torch import trace
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.engine.mapwrap import (
    map_query_file_against_shard, unify_query_file)
from metamaps_tpu_torch.ops.winnow import winnow_np
from metamaps_tpu_torch.params import Parameters
from portbench import core

from util_db import write_reads_fastq
from util_sim import random_genome, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
READERS = ("unify.mapq_ms", "mapfile.parse_ms", "mapfile.write_ms",
           "engine.reads_per_chunk", "unify.lines_per_mapq_batch",
           "l1.hits_per_read", "lookup.threshold_dropped_pct",
           "l1.candidates_max", "sketch.kernel_chunk_pct")
#: the engine's counters on each ``engine.chunk`` span
CHUNK_COUNTERS = ("hits", "hits_over_threshold", "cands_max_read")
PHASES = ("upload", "sketch", "minhits", "lookup", "l1", "l2", "collect")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A shard of three random genomes, a FASTQ of 14 reads over two
    length buckets, one of them too short to map, and one of its first two
    reads (the profiler's test: a traced op is slow to record)."""
    root = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(20261018)
    genomes = [random_genome(rng, 40000) for _ in range(3)]
    params = Parameters(kmer_size=16, window_size=16, min_read_length=2000,
                        percentage_identity=80.0,
                        reference_size=sum(len(g) for g in genomes))
    shard = SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        parts.append((*winnow_np(g, 16, 16), i))
        shard.contig_names.append(f"C{i}|kraken:taxid|{1000 + i}|X{i}.1")
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    reads = sample_reads(rng, genomes, 7, min_len=2000, max_len=2048)
    reads += sample_reads(rng, genomes, 6, min_len=3100, max_len=4000)
    reads += [(genomes[0][:1500],)]
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)
    write_reads_fastq(str(root / "two.fastq"), reads[:2])
    return root, shard, params, fq


def _map_and_unify(mini, tag, engine, fastq="reads.fastq"):
    """Map and unify a FASTQ with ``engine``; the spans that started in
    the call, and the unified output's prefix."""
    root, shard, params, _ = mini
    fq = str(root / fastq)
    prefix = str(root / tag)
    t0 = time.perf_counter_ns()
    map_query_file_against_shard(shard, params, fq, prefix + ".0",
                                 mapper=engine)
    unify_query_file(prefix, fq, params, [prefix + ".0"])
    return [s for s in trace.spans() if s.t0_ns >= t0], prefix


def _one(spans, name):
    got = [s for s in spans if s.name == name]
    assert len(got) == 1, (name, got)
    return got[0]


def test_spans_of_a_map_and_unify_nest(mini):
    eng = TorchMapperEngine(mini[1], mini[2], device="cpu")
    spans, prefix = _map_and_unify(mini, "nest", eng)
    mapfile, unify = _one(spans, "mapfile"), _one(spans, "unify")
    for root in (mapfile, unify):
        assert root.parent == 0 and root.root == root.id
    assert mapfile.attrs == {"file": prefix + ".0", "reads_total": 14,
                             "mappable": 13}
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent:
            parent = by_id[s.parent]
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
            assert s.root == mapfile.id
    for name in ("mapfile.parse", "engine.map_reads", "mapfile.write"):
        assert by_id[_one(spans, name).parent] is mapfile
    assert (_one(spans, "mapfile.parse").t1_ns
            <= _one(spans, "engine.map_reads").t0_ns)
    assert (_one(spans, "engine.map_reads").t1_ns
            <= _one(spans, "mapfile.write").t0_ns)
    chunks = [s for s in spans if s.name == "engine.chunk"]
    assert sorted(c.attrs["bucket"] for c in chunks) == [2048, 4096]
    assert sum(c.attrs["reads"] for c in chunks) == 13
    assert {by_id[c.parent].name for c in chunks} == {"engine.map_reads"}
    assert [c.attrs["sketch_kernel"] for c in chunks] == [0, 0]  # the CPU
    for c in chunks:
        names = [s.name for s in spans if s.parent == c.id]
        assert [n for n in names if n != "engine.minhits"] == [
            "engine.upload", "engine.sketch", "engine.lookup", "engine.l1",
            "engine.l2", "engine.collect"]
    for s in spans:
        if s.name == "engine.oracle":
            assert by_id[s.parent].name == "engine.collect"
    assert len([s for s in spans if s.name == "engine.oracle"]) == 2
    with open(prefix) as f:
        lines = sum(1 for _ in f)
    assert unify.attrs["file"] == prefix
    assert unify.attrs["reads"] == 13 and unify.attrs["lines"] == lines > 0
    assert 0 < unify.attrs["mapq_s"] < (unify.t1_ns - unify.t0_ns) * 1e-9
    assert unify.attrs["mapq_batches"] == 1  # 13 reads, one batch


def test_phase_spans_sum_to_phase_seconds(mini):
    eng = TorchMapperEngine(mini[1], mini[2], device="cpu")
    _map_and_unify(mini, "warm", eng)  # the minimum-hits table is built
    before = dict(eng.stats["phase_s"])
    spans, _ = _map_and_unify(mini, "phases", eng)
    for key in PHASES + ("oracle",):
        want = sum(s.t1_ns - s.t0_ns for s in spans
                   if s.name == "engine." + key) * 1e-9
        got = eng.stats["phase_s"][key] - before.get(key, 0.0)
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), key
    assert "engine.minhits" not in {s.name for s in spans}


def test_spans_sit_inside_the_callers_profiler_annotation(mini, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = TorchMapperEngine(mini[1], mini[2], device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.outer"):
            _map_and_unify(mini, "profiled", eng, "two.fastq")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    outer, = [e for e in events if e["name"] == "portbench.outer"]
    a, b = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    for name in ("metamaps.mapfile", "metamaps.engine.chunk",
                 "metamaps.unify"):
        got = [e for e in events if e["name"] == name]
        assert got, name
        for e in got:
            assert a <= float(e["ts"]) <= float(e["ts"]) + float(e["dur"]) <= b


def test_no_annotation_without_a_profiler(mini, monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    eng = TorchMapperEngine(mini[1], mini[2], device="cpu")
    spans, _ = _map_and_unify(mini, "unprofiled", eng)
    assert spans and opened == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert opened == ["metamaps.probe"]


def _ctx(files):
    return SimpleNamespace(root=ROOT, trace=True, record={"files": files})


def _record(name, t0_s, t1_s, **attrs):
    return trace.SpanRecord(name, 0, 0, 0, round(t0_s * 1e9),
                            round(t1_s * 1e9), attrs)


def test_readers_on_a_hand_built_context(monkeypatch):
    # a window of two files from 100 s to 102 s, 400 mappable reads
    files = [dict(t0=100.0, t2=101.0, reads=150),
             dict(t0=101.0, t2=102.0, reads=250)]
    recs = [
        _record("mapfile.parse", 99.0, 99.5),  # before the window
        _record("engine.chunk", 99.1, 99.2, bucket=4096, reads=999, hits=9,
                hits_over_threshold=9, cands_max_read=99, sketch_kernel=0),
        _record("mapfile.parse", 100.1, 100.103),
        _record("mapfile.parse", 101.1, 101.101),
        _record("mapfile.write", 100.2, 100.202),
        _record("engine.chunk", 100.15, 100.16, bucket=4096, reads=80,
                hits=8000, hits_over_threshold=100, cands_max_read=3,
                sketch_kernel=1),
        _record("engine.chunk", 100.16, 100.17, bucket=5120, reads=100,
                hits=12000, hits_over_threshold=0, cands_max_read=24,
                sketch_kernel=0),
        _record("engine.chunk", 101.15, 101.16, bucket=4096, reads=120,
                hits=10000, hits_over_threshold=300, cands_max_read=7,
                sketch_kernel=1),
        _record("unify", 100.5, 100.9, lines=160, mapq_batches=1, mapq_s=0.03),
        _record("unify", 101.5, 101.9, lines=290, mapq_batches=2, mapq_s=0.05),
        _record("mapfile.write", 102.5, 102.6),  # after the window
    ]
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    monkeypatch.setattr(trace, "reaches", lambda t_ns: True)
    got = {m: core.load_piece(ROOT, "metrics", m).read(_ctx(files), None)
           for m in READERS}
    assert got["mapfile.parse_ms"] == pytest.approx(1e6 * 0.004 / 400)
    assert got["mapfile.write_ms"] == pytest.approx(1e6 * 0.002 / 400)
    assert got["unify.mapq_ms"] == pytest.approx(1e6 * 0.08 / 400)
    assert got["engine.reads_per_chunk"] == pytest.approx(100.0)
    assert got["unify.lines_per_mapq_batch"] == pytest.approx(150.0)
    assert got["l1.hits_per_read"] == pytest.approx(30000 / 300)
    assert got["lookup.threshold_dropped_pct"] == pytest.approx(
        100.0 * 400 / 30400)
    assert got["l1.candidates_max"] == 24
    assert got["sketch.kernel_chunk_pct"] == pytest.approx(100.0 * 2 / 3)


@pytest.mark.parametrize("unify_attrs", [
    dict(lines=7, mapq_s=0.01),  # a program without the counter
    dict(lines=0, mapq_batches=0, mapq_s=0.0),  # no read mapped
])
def test_lines_per_mapq_batch_reads_none_without_batches(monkeypatch,
                                                         unify_attrs):
    files = [dict(t0=100.0, t2=101.0, reads=10)]
    recs = [_record("unify", 100.5, 100.9, **unify_attrs)]
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    monkeypatch.setattr(trace, "reaches", lambda t_ns: True)
    reader = core.load_piece(ROOT, "metrics", "unify.lines_per_mapq_batch")
    assert reader.read(_ctx(files), None) is None
    mapq = core.load_piece(ROOT, "metrics", "unify.mapq_ms")
    assert mapq.read(_ctx(files), None) == pytest.approx(
        1e6 * unify_attrs["mapq_s"] / 10)


@pytest.mark.parametrize("chunk_attrs", [
    dict(bucket=4096, reads=10),  # a program without the counters
    dict(bucket=4096, reads=10, hits=0, hits_over_threshold=0,
         cands_max_read=0),  # no minimizer of a read found
])
def test_l1_readers_without_counters_or_hits(monkeypatch, chunk_attrs):
    files = [dict(t0=100.0, t2=101.0, reads=10)]
    recs = [_record("engine.chunk", 100.5, 100.6, **chunk_attrs)]
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    monkeypatch.setattr(trace, "reaches", lambda t_ns: True)
    got = {m: core.load_piece(ROOT, "metrics", m).read(_ctx(files), None)
           for m in ("l1.hits_per_read", "lookup.threshold_dropped_pct",
                     "l1.candidates_max")}
    if "hits" in chunk_attrs:
        assert got == {"l1.hits_per_read": 0.0,
                       "lookup.threshold_dropped_pct": None,
                       "l1.candidates_max": 0}
    else:
        assert set(got.values()) == {None}


@pytest.mark.parametrize("kernel", [None, (1, None), (1, 1, 1), (0, 0)],
                         ids=["parent", "one_without", "all", "none"])
def test_sketch_kernel_reader(monkeypatch, kernel):
    """None where a chunk span lacks ``sketch_kernel`` (a program without
    the counter), else the share of chunks with 1."""
    files = [dict(t0=100.0, t2=101.0, reads=30)]
    marks = kernel or (None,)
    recs = [_record("engine.chunk", 100.1 + 0.1 * i, 100.15 + 0.1 * i,
                    bucket=4096, reads=10,
                    **({} if m is None else {"sketch_kernel": m}))
            for i, m in enumerate(marks)]
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    monkeypatch.setattr(trace, "reaches", lambda t_ns: True)
    got = core.load_piece(ROOT, "metrics", "sketch.kernel_chunk_pct").read(
        _ctx(files), None)
    if None in marks:
        assert got is None
    else:
        assert got == pytest.approx(100.0 * sum(marks) / len(marks))


@pytest.fixture(scope="module")
def near_copies():
    """A shard of a genome with five near-copies (1 % substitutions), a
    genome that carries one 16-mer every 1 kb, an unrelated genome, and 16
    ONT-like reads of the first two over several length buckets. The
    16-mer is the one of smallest hash in 200 kb of random bases, so every
    window that holds it picks it: its 400 occurrences are the shard's
    most, and the frequency threshold (0.001 % of ~190,000 distinct
    hashes: one) removes them."""
    from metamaps_tpu_torch.ops.winnow import canonical_hashes_np
    from metamaps_tpu_torch.sim import synth_db

    rng = np.random.default_rng(20261019)
    backbone = random_genome(rng, 150_000)
    host = random_genome(rng, 400_000)
    pool = random_genome(rng, 200_000)
    canon, _, valid = canonical_hashes_np(pool, 16)
    at = int(np.argmin(np.where(valid, canon, np.iinfo(np.int64).max)))
    for p in range(500, len(host) - 16, 1000):
        host[p:p + 16] = pool[at:at + 16]
    genomes = ([backbone] + [synth_db.mutate_sub(rng, backbone, 0.01)
                             for _ in range(5)]
               + [host, random_genome(rng, 1_000_000)])
    shard = SketchShard(contig_names=[f"C{i}" for i in range(len(genomes))],
                        contig_lengths=[len(g) for g in genomes])
    shard.finalize([(*winnow_np(g, 16, 16), i) for i, g in enumerate(genomes)])
    params = Parameters(kmer_size=16, window_size=16, min_read_length=2000,
                        percentage_identity=80.0,
                        reference_size=sum(len(g) for g in genomes))
    reads = [synth_db.ont_read(rng, genomes[g], int(n))
             for g in (0, 6) for n in rng.integers(2000, 7000, 8)]
    return shard, params, reads, genomes


def test_chunk_counters_match_the_oracles_l1(near_copies):
    """``engine.chunk``'s ``hits``, ``hits_over_threshold`` and
    ``cands_max_read`` against the JAX package's serial oracle: its shard's
    lookup and its ``l1_candidates`` on the same reads."""
    from metamaps_tpu import stats as jstats
    from metamaps_tpu.engine import index as jindex
    from metamaps_tpu.engine import mapper_oracle as joracle
    from metamaps_tpu.ops.winnow import winnow_np as jwinnow_np

    shard, params, reads, genomes = near_copies
    jshard = jindex.SketchShard(contig_names=list(shard.contig_names),
                                contig_lengths=list(shard.contig_lengths))
    jshard.finalize([(*jwinnow_np(g, 16, 16), i)
                     for i, g in enumerate(genomes)])
    eng = TorchMapperEngine(shard, params, device="cpu")
    t0 = time.perf_counter_ns()
    eng.map_reads(reads)
    chunks = [s for s in trace.spans()
              if s.name == "engine.chunk" and s.t0_ns >= t0]
    want = {}
    for seq in reads:
        q, _, _ = joracle.sketch_read(seq, 16, 16)
        _, count = jshard.lookup_counts(q)
        over = count >= jshard.freq_threshold
        regions = joracle.l1_candidates(
            jshard, q, len(seq),
            jstats.estimate_minimum_hits_relaxed(q.size, 16, 80.0))
        got = want.setdefault(eng._bucket_of(len(seq)), [0, 0, 0])
        got[0] += int(count[~over].sum())
        got[1] += int(count[over].sum())
        got[2] = max(got[2], len(regions))
    assert eng.stats["oracle_fallbacks"] == 0
    assert sorted(c.attrs["bucket"] for c in chunks) == sorted(want)
    for c in chunks:
        assert [c.attrs[k] for k in CHUNK_COUNTERS] == want[c.attrs["bucket"]]
    totals = np.sum(list(want.values()), axis=0)
    assert totals[1] > 0 and max(w[2] for w in want.values()) >= 2


def test_readers_give_none_once_the_ring_has_left_the_window():
    t0 = time.perf_counter()
    with trace.span("unify", lines=12, mapq_batches=1, mapq_s=0.01):
        pass
    with trace.span("engine.chunk", bucket=2048, reads=10, hits=500,
                    hits_over_threshold=5, cands_max_read=2, sketch_kernel=1):
        pass
    with trace.span("mapfile.parse"):
        pass
    with trace.span("mapfile.write"):
        pass
    files = [dict(t0=t0, t2=time.perf_counter(), reads=10)]
    readers = {m: core.load_piece(ROOT, "metrics", m) for m in READERS}
    assert all(r.read(_ctx(files), None) is not None
               for r in readers.values())
    for _ in range(trace.RING):
        with trace.span("filler"):
            pass
    assert not trace.reaches(round(t0 * 1e9))
    assert all(r.read(_ctx(files), None) is None for r in readers.values())
    assert len(trace.spans()) == trace.RING


def test_profile_changes_no_byte_on_the_cpu(mini):
    out = {}
    for profile in (False, True):
        eng = TorchMapperEngine(mini[1], mini[2], device="cpu",
                                profile=profile)
        _, prefix = _map_and_unify(mini, f"profile{int(profile)}", eng)
        out[profile] = [Path(prefix + suffix).read_bytes() for suffix in
                        ("", ".meta", ".meta.unmappedReadsLengths")]
    assert out[True] == out[False]


def test_threads_record_every_span_under_their_own_parents():
    n_threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with trace.span("stress.outer", thread=k):
                for i in range(per):
                    with trace.span("stress.inner", thread=k, i=i):
                        pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = trace.spans()[-n_threads * (per + 1):]
    outer = {r.attrs["thread"]: r for r in recs if r.name == "stress.outer"}
    inner = [r for r in recs if r.name == "stress.inner"]
    assert len(outer) == n_threads and len(inner) == n_threads * per
    assert len({r.id for r in recs}) == len(recs)
    for r in inner:
        assert r.parent == r.root == outer[r.attrs["thread"]].id
