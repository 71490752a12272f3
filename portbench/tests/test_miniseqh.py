"""The ``miniseqh`` configuration on the CPU at a tiny size (about 20 Mbp,
the same rules): its strains, clusters, read shares and determinism, and
the reference against the program's engine and serial oracle on a shard
where a read meets every strain of its species.

    python -m pytest portbench/tests/test_miniseqh.py -q
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import core
from portbench.tests import tiny

SCALE = 50  # 1 Gbp / 50 = 20 Mbp


def tiny_config() -> dict:
    """``configs/miniseqh.json`` with every genome and the shard cut by
    ``SCALE`` (so as many contigs as at full size)."""
    cfg = json.loads((tiny.ROOT / "portbench" / "configs" / "miniseqh.json")
                     .read_text())
    for sp in cfg["species"]:
        sp["mbp"] /= SCALE
    cfg["shard_bases"] //= SCALE
    cfg["background"]["mean_mbp"] /= SCALE
    return cfg


@pytest.fixture(scope="module")
def setup_mod():
    """The set-up module; the reference's own ``l2_best`` is put back
    after the module's tests (``genomes`` hands it ``l2_states``')."""
    from portbench.reference import mapping

    plain = mapping.l2_best
    yield core.load_piece(tiny.ROOT, "setups", "miniseqh")
    mapping.l2_best = plain


@pytest.fixture(scope="module")
def shard(setup_mod):
    cfg = tiny_config()
    genomes, names = setup_mod.genomes(cfg)
    return cfg, genomes, names


def provenance(e) -> np.ndarray:
    """For each base of the strain that ``e`` (``Edits``) makes, the
    backbone position it descends from, or ACCESSORY or INSERTED for a
    base of its own."""
    kept = np.flatnonzero(e.alive()).astype(np.int64)
    return np.insert(kept, e.insert_at(), np.repeat(e.kind, e.i_len))


def test_strains_keep_their_ani_and_accessory_share(setup_mod):
    """Each strain's bases that descend from its backbone differ from it at
    1 - ANI of them, ANI in 97-99.9 %; accessory bases are the stated
    share of its length (to within one segment's rounding)."""
    cfg = tiny_config()
    st = cfg["strain"]
    lay = setup_mod.layout(cfg)
    assert all(st["ani_min"] <= g.ani <= st["ani_max"] for g in lay)
    rng = np.random.default_rng(7)
    picks = [lay[0], lay[8], max(lay, key=lambda g: g.ani),
             min(lay, key=lambda g: g.ani), max(lay, key=lambda g: g.length)]
    for g in picks:
        backbone = setup_mod.random_bases(rng, g.length, g.gc)
        e = setup_mod.edits(rng, g.length, g.ani, g.gc, st)
        seq, src = setup_mod.apply(backbone, e), provenance(e)
        assert seq.size == src.size
        desc = src >= 0
        assert np.all(np.diff(src[desc]) > 0)
        ani = float(np.mean(seq[desc] == backbone[src[desc]]))
        assert st["ani_min"] <= ani <= st["ani_max"]
        assert ani == pytest.approx(g.ani, abs=1.0 / desc.sum())
        accessory = float(np.mean(src == setup_mod.ACCESSORY))
        assert accessory == pytest.approx(
            st["accessory_share"], abs=st["accessory_min_bp"] / 2 / g.length)
        inserted = int(np.sum(src == setup_mod.INSERTED))
        assert 0 < inserted <= st["indel_max_bp"] * st[
            "indel_per_substitution"] * (1 - g.ani) * g.length * 2


def test_clusters_and_shard_size(setup_mod):
    cfg = tiny_config()
    lay = setup_mod.layout(cfg)
    sizes = {}
    for g in lay:
        sizes.setdefault(g.cluster, []).append(g.strain)
    for c, sp in enumerate(cfg["species"]):
        assert sizes[c] == list(range(sp["strains"]))
        assert all(g.gc == sp["gc"] for g in lay if g.cluster == c)
    background = [sizes[c] for c in sizes if c >= len(cfg["species"])]
    assert background and all(1 <= len(s) <= cfg["background"]["cluster_max"]
                              for s in background[:-1])
    assert sum(len(s) for s in sizes.values()) == len(lay) > 80
    total = sum(g.length for g in lay)
    assert cfg["shard_bases"] <= total < cfg["shard_bases"] + lay[-1].length


def test_reads_come_from_the_sample_strains_only(setup_mod):
    cfg = tiny_config()
    lay = setup_mod.layout(cfg)
    share = setup_mod.read_shares(cfg)
    assert share.size == len(lay) and share.sum() == pytest.approx(1.0)
    live = np.flatnonzero(share)
    assert [lay[i].name.split("|")[0] for i in live] == [
        f"{sp['name']}.s0" for sp in cfg["species"]]
    want = np.array([sp["dna_share"] for sp in cfg["species"]])
    assert np.allclose(share[live], want / want.sum())


def test_the_same_seed_gives_the_same_bytes(setup_mod, shard):
    cfg, genomes, names = shard
    again, names2 = setup_mod.genomes(cfg)
    assert names2 == names
    assert all(np.array_equal(a, b) for a, b in zip(genomes, again))
    assert sum(len(g) for g in genomes) == pytest.approx(cfg["shard_bases"],
                                                         rel=0.02)
    other = dict(cfg, db_seed=cfg["db_seed"] + 1)
    assert not np.array_equal(setup_mod.genomes(other)[0][0], genomes[0])


def test_region_tables_score_as_the_reference(setup_mod, shard):
    """``l2_states.l2_best`` against the reference's state-by-state
    ``l2_best`` on every candidate region of reads of each sample strain,
    and on a region that holds a hash twice (which it hands over)."""
    from portbench.frozen.synth_db import ont_read
    from portbench.reference import l2_states, mapping

    cfg, genomes, names = shard
    rng = np.random.default_rng(11)
    reads = [ont_read(rng, genomes[i], int(rng.integers(3000, 7600)))
             for i in np.flatnonzero(setup_mod.read_shares(cfg))
             for _ in range(2)]
    twice = genomes[1].copy()
    twice[5000:5400] = twice[1000:1400]  # a window's hashes again
    reads.append(ont_read(rng, twice[:12000], 7000))
    index = mapping.Index(genomes + [twice], 16, 16, "cpu")
    sketches = [mapping.read_sketch(*mapping.minimizers(r, 16, 16)[::2])
                for r in reads]
    index.prepare_hits(np.concatenate([q for q, _ in sketches]))
    n = 0
    for r, (q, _) in zip(reads, sketches):
        for region in mapping.l1_regions(index, q, len(r),
                                         mapping.minimum_hits(q.size, 16, 80.0)):
            want = l2_states.per_state(index, q, len(r), 16, 16, region)
            assert l2_states.l2_best(index, q, len(r), 16, 16, region) == want
            n += 1
    assert n > 5 * len(reads)


def _lines(name, maps, names, lengths, p):
    from metamaps_tpu_torch.engine import mapper_oracle, mapwrap
    from metamaps_tpu_torch.io.mappings import MappingLine

    ms = mapper_oracle.report_filter(maps, p.report_all)
    return mapwrap.add_mapping_qualities(p, [MappingLine(
        read_id=name, read_len=m.query_len, strand=m.strand,
        contig_id=names[m.ref_seqid], contig_len=lengths[m.ref_seqid],
        ref_start=m.ref_start, ref_end=m.ref_end, identity=m.nuc_identity,
        intersection=m.conserved, sketch_size=m.sketch_size).format()
        for m in ms])


def test_reference_agrees_with_the_engine_and_the_oracle(setup_mod, shard):
    """Reads of each sample strain (three a bacterium, one a yeast: their
    shares of DNA) meet the strains of their species: the reference's
    unified lines, the engine's and the serial oracle's are identical. A
    read gets a line from each strain that holds its locus: its own, less
    where it comes from its strain's accessory segments (a share a of its
    length), and each other strain's where the locus is in neither's
    accessory, 1 + (1 - a)^2 (S - 1) lines for S strains; the mean is at
    least nine tenths of that (7.5 a read here: 7.8 on the cell's mix)."""
    from metamaps_tpu_torch.engine import mapper_oracle
    from metamaps_tpu_torch.engine.index import SketchShard
    from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
    from metamaps_tpu_torch.ops.winnow import winnow_fast
    from metamaps_tpu_torch.params import Parameters

    from portbench.frozen.synth_db import ont_read
    from portbench.reference import mapping

    cfg, genomes, names = shard
    share = setup_mod.read_shares(cfg)
    rng = np.random.default_rng(2**31 + 17)
    reads, expected = {}, 0.0
    kept = (1 - cfg["strain"]["accessory_share"]) ** 2
    for i, sp in zip(np.flatnonzero(share), cfg["species"]):
        for r in range(3 if share[i] > 0.1 else 1):
            expected += 1 + kept * (sp["strains"] - 1)
            reads[f"g{i}r{r}"] = ont_read(rng, genomes[i],
                                          int(rng.integers(3000, 7600)))
    lengths = [len(g) for g in genomes]
    p = Parameters(reference_size=sum(lengths), **cfg["params"])
    sh = SketchShard(contig_names=list(names), contig_lengths=lengths)
    sh.finalize([(*winnow_fast(g, 16, 16), i) for i, g in enumerate(genomes)])
    engine = TorchMapperEngine(sh, p, device="cpu")
    got = dict(zip(reads, engine.map_reads(list(reads.values()))))
    assert engine.stats["oracle_fallbacks"] == 0
    index = mapping.Index(genomes, 16, 16, "cpu")
    assert index.threshold == sh.freq_threshold
    want, = mapping.expected_lines(index, cfg["params"], names, lengths,
                                   reads, workers=4)
    for name, seq in reads.items():
        assert _lines(name, got[name], names, lengths, p) == want[name], name
        oracle = mapper_oracle.map_read(sh, p, seq)
        assert _lines(name, oracle, names, lengths, p) == want[name], name
    assert sum(len(v) for v in want.values()) >= 0.9 * expected > 6 * len(want)


def test_the_cell_runs_on_the_cpu(tmp_path, monkeypatch):
    """``miniseqh.ont_files`` at the tiny size, traced: correct, with many
    candidates a read, none sent to the oracle, and the engine's L1
    counters read. The reference's own ``l2_best``, which the cell's set-up
    replaces, is put back after the test."""
    from portbench.reference import mapping

    monkeypatch.setattr(mapping, "l2_best", mapping.l2_best)
    root = tiny.tiny_root(tmp_path / "root")
    (root / "portbench" / "configs" / "miniseqh.json").write_text(
        json.dumps(tiny_config()))
    rc, last, _ = tiny.run_cell(root, "miniseqh.ont_files", seed=2**31 + 3,
                                trace=1)
    assert rc == 0 and last["correct"] is True
    m = {k: v["value"] for k, v in last["metrics"].items()}
    assert m["l2.candidates_per_read"] > 4
    assert m["collect.oracle_fallback_pct"] == 0
    assert m["l1.hits_per_read"] > 100 and m["l1.candidates_max"] >= 8
    assert 0 <= m["lookup.threshold_dropped_pct"] < 100
