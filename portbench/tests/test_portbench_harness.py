"""The harness on the CPU at a tiny size: cells resolve to their pieces, a
new piece is found with no edit, the last line's keys, the frozen copies
against the program's originals, and each reference against the program.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from portbench import core
from portbench.tests import tiny

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny") / "root")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_pieces(cell):
    c = core.resolve(tiny.ROOT, cell)
    setup_mod = core.load_piece(tiny.ROOT, "setups", c.config_name)
    driver = core.load_piece(tiny.ROOT, "drivers", c.traffic["kind"])
    for fn in ("setup", "window", "traced", "counts", "check", "control"):
        assert callable(getattr(driver, fn))
    assert callable(setup_mod.genomes) and callable(setup_mod.read_shares)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(core.load_piece(tiny.ROOT, "metrics", m["name"]).read)
    for key in ("source", "reduced", "assumed"):
        assert key in c.config
    assert len(c.config["source"]) <= 200


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", CELLS), (m["name"], cell)


def test_new_cell_mix_and_metric_are_found_without_an_edit(root, tmp_path):
    new = tmp_path / "root"
    shutil.copytree(root, new)
    pb = new / "portbench"
    mix = json.loads((pb / "traffic" / "ont_files.json").read_text())
    mix.update(reads_per_file=8, pool_files=2)
    (pb / "traffic" / "ont_small.json").write_text(json.dumps(mix))
    (pb / "metrics" / "files.done.py").write_text(
        '"""files.done: files completed in the window."""\n\n\n'
        'def read(ctx, st):\n    return len(ctx.record["files"])\n')
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "zymo.ont_small", "config": "zymo",
                               "traffic": "ont_small", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "files.done", "unit": "files",
                               "better": "higher", "source": "program_counter",
                               "layer": "per-file path", "moves": "reads_per_s",
                               "workloads": ["zymo.ont_small"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "zymo.ont_files" in m["workloads"]:
            m["workloads"].append("zymo.ont_small")
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, last, _ = tiny.run_cell(new, "zymo.ont_small", seed=3, trace=1)
    assert rc == 0 and last["correct"]
    assert last["metrics"]["files.done"]["value"] >= 1


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(root, trace):
    rc, last, _ = tiny.run_cell(root, "zymo.ont_files", seed=2**31 + 11,
                                trace=trace)
    assert rc == 0
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace and "breakdown" in last:
        want.append("breakdown")
    assert list(last) == want + ["checks"]  # the compared numbers come last
    assert last["correct"] is True
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cell = core.resolve(root, "zymo.ont_files")
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(last["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
    else:  # the CPU path reports no device metric
        assert {"reads_per_s", "file_p95_s", "setup_s"} == set(last["metrics"])


def test_frozen_read_generator_matches_the_programs():
    from metamaps_tpu_torch.sim import synth_db as prog

    from portbench.frozen import synth_db as frozen

    genome = frozen.BASES[np.random.default_rng(9).integers(0, 4, 50_000)]
    for seed in (1, 2**31 + 5):
        assert np.array_equal(
            frozen.ont_read(np.random.default_rng(seed), genome, 5000),
            prog.ont_read(np.random.default_rng(seed), genome, 5000))


def test_frozen_sweep_bound_matches_the_programs():
    from metamaps_tpu_torch.profiling import sweep_bench

    from portbench.frozen import sweep_bound

    for name, host, sp, _ in sweep_bench.bench_inputs():
        meta, qrank, signinq, _ = host
        for kw in ({}, {"sp": sp}):
            got = sweep_bound.sweep_bound(meta, qrank, signinq, 1980.0, **kw)
            want = sweep_bench.sweep_bound(meta, qrank, signinq, 1980.0, **kw)
            assert got == want, name
        assert all(np.array_equal(x, y) for x, y in zip(
            sweep_bound.sweep_routes(meta, qrank, signinq, sp),
            sweep_bench.sweep_routes(meta, qrank, signinq, sp)))


def test_reference_minimizers_match_the_programs():
    from metamaps_tpu_torch.ops.winnow import winnow_fast

    from portbench.reference.mapping import minimizers

    rng = np.random.default_rng(0)
    for n in (15, 40, 3000, 200_000):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        seq[:32] = ord("A")  # symmetric k-mers and a run at window 0
        h, p, s = winnow_fast(seq, 16, 16)
        h2, p2, s2 = minimizers(seq, 16, 16)
        assert np.array_equal(h, h2) and np.array_equal(p, p2)
        assert np.array_equal(s, s2)


def _program_lines(shard, p, names, lengths, reads):
    """The program's serial path: its oracle, report filter, line format
    and mapping qualities."""
    from metamaps_tpu_torch.engine import mapper_oracle, mapwrap
    from metamaps_tpu_torch.io.mappings import MappingLine

    out = {}
    for name, seq in reads.items():
        ms = mapper_oracle.report_filter(mapper_oracle.map_read(shard, p, seq),
                                         p.report_all)
        out[name] = mapwrap.add_mapping_qualities(p, [MappingLine(
            read_id=name, read_len=m.query_len, strand=m.strand,
            contig_id=names[m.ref_seqid], contig_len=lengths[m.ref_seqid],
            ref_start=m.ref_start, ref_end=m.ref_end, identity=m.nuc_identity,
            intersection=m.conserved, sketch_size=m.sketch_size).format()
            for m in ms])
    return out


@pytest.mark.parametrize("report_all", [True, False])
def test_mapping_reference_agrees_with_the_program(report_all):
    """The reference's lines against the program's on a small database
    with near-copies, shared segments and repeat families (many candidates
    a read, a binding frequency threshold); its threshold against
    ``SketchShard.finalize``'s."""
    from metamaps_tpu_torch.engine.index import SketchShard
    from metamaps_tpu_torch.ops.winnow import winnow_fast
    from metamaps_tpu_torch.params import Parameters
    from metamaps_tpu_torch.sim import synth_db

    from portbench.reference import mapping

    rng = np.random.default_rng(20260820)
    genomes, names = synth_db.synth_structured_db(rng, total_bases=3_000_000)
    reads = {f"r{i}": r for i, r in
             enumerate(synth_db.make_ont_reads(rng, genomes, 6))}
    reads["short"] = reads["r0"][:1500]
    params = dict(kmer_size=16, window_size=16, percentage_identity=80.0,
                  min_read_length=2000, report_all=report_all)
    lengths = [len(g) for g in genomes]
    shard = SketchShard(contig_names=list(names), contig_lengths=lengths)
    shard.finalize([(*winnow_fast(g, 16, 16), i) for i, g in enumerate(genomes)])
    index = mapping.Index(genomes, 16, 16, "cpu")
    assert index.threshold == shard.freq_threshold < mapping.INT_MAX
    want, = mapping.expected_lines(index, params, names, lengths, reads,
                                   workers=2)
    got = _program_lines(shard, Parameters(**params), names, lengths,
                         {n: r for n, r in reads.items() if n != "short"})
    assert "short" not in want
    if report_all:
        assert sum(len(v) for v in got.values()) > 2 * len(got)
    assert got == want


def test_mapping_qualities_follow_the_binomial_model():
    """Two lines of one read: each line's quality is its binomial
    likelihood's share, the corrected identity e^-(1-identity)."""
    from scipy import stats

    from portbench.reference.mapping import mapping_qualities

    head = "r 5000 0 4999 + c 9000 10 5009"
    out = mapping_qualities([f"{head} 90 300 590", f"{head} 85 250 590"], 16)
    n = 5000 - 16 + 1
    e = round(np.exp(-0.1) ** 16 * n)
    lik = stats.binom.pmf([300, 250], 590, e / (2 * n - e))
    fields = [ln.split(" ") for ln in out]
    assert [f[12] for f in fields] == ["%.6g" % (np.float32(np.exp(-0.1)) * np.float32(100)),
                                       "%.6g" % (np.float32(np.exp(-0.15)) * np.float32(100))]
    assert np.allclose([float(f[13]) for f in fields], lik / lik.sum(), rtol=1e-5)


@pytest.mark.cuda
def test_reference_minimizers_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from metamaps_tpu_torch.ops.winnow import winnow_fast

    from portbench.reference.mapping import minimizers

    seq = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(2).integers(0, 4, 5_000_000)].copy()
    h, p, s = winnow_fast(seq, 16, 16)
    h2, p2, s2 = minimizers(seq, 16, 16, "cuda")
    assert np.array_equal(h, h2) and np.array_equal(p, p2)
    assert np.array_equal(s, s2)
