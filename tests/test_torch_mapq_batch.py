"""Mapping qualities of many reads at once in ``unify_files``.

The port's ``unify_files`` computes the mapping qualities of up to
``BATCH_READS`` mapped reads with one binomial pmf call; the JAX package's
computes them read by read. On the same per-shard outputs both write the
unified file and its ``.meta``, ``.meta.unmappedReadsLengths`` and
``.parameters`` sidecars byte for byte alike: with ``--all`` and without,
over two shards, with unmapped and too-short reads, and with a batch
boundary inside the file. Malformed lines and a read whose likelihoods sum
to zero still raise, naming the read.
"""
import math
import shutil

import numpy as np
import pytest

from metamaps_tpu.engine import mapwrap as jax_mapwrap
from metamaps_tpu.params import Parameters as JaxParameters
from metamaps_tpu_torch import trace
from metamaps_tpu_torch.engine import mapwrap
from metamaps_tpu_torch.engine.index import SketchShard
from metamaps_tpu_torch.io.mappings import MappingLine
from metamaps_tpu_torch.ops.winnow import winnow_np
from metamaps_tpu_torch.params import Parameters

from util_db import write_reads_fastq
from util_sim import mutate, random_genome, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

PARAMS = dict(kmer_size=16, window_size=16, min_read_length=2000,
              percentage_identity=80.0, reference_size=160_000)
SIDECARS = ("", ".meta", ".meta.unmappedReadsLengths", ".parameters")


def _shard(genomes, names):
    shard = SketchShard()
    parts = []
    for i, (g, name) in enumerate(zip(genomes, names)):
        parts.append((*winnow_np(g, 16, 16), i))
        shard.contig_names.append(name)
        shard.contig_lengths.append(len(g))
    shard.finalize(parts)
    return shard


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """Per report_all, the oracle's outputs of one FASTQ against two shards.
    Shard 0 holds a genome and a near copy of it, shard 1 a second near
    copy and an unrelated genome, so a read of the first genome has lines
    in both shards; the FASTQ also holds a too-short read and a random,
    unmapped one."""
    root = tmp_path_factory.mktemp("mapq_batch")
    rng = np.random.default_rng(20261018)
    base = random_genome(rng, 40000)
    genomes = [base, mutate(rng, base, sub=0.01), mutate(rng, base, sub=0.02),
               random_genome(rng, 40000)]
    names = [f"G{i}|kraken:taxid|{100 + i}|X{i}.1" for i in range(4)]
    shards = [_shard(genomes[:2], names[:2]), _shard(genomes[2:], names[2:])]
    reads = sample_reads(rng, genomes, 14, min_len=2000, max_len=4000,
                         sub=0.04)
    reads.insert(5, (random_genome(rng, 1500),))  # too short
    reads.insert(9, (random_genome(rng, 3000),))  # maps nowhere
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)
    out = {}
    for report_all in (False, True):
        params = Parameters(**PARAMS, report_all=report_all)
        files = []
        for i, shard in enumerate(shards):
            files.append(str(root / f"all{int(report_all)}.{i}"))
            mapwrap.map_query_file_against_shard(shard, params, fq, files[-1],
                                                 engine="oracle")
        out[report_all] = files
    return root, fq, out


def _unify(unify_files, params_cls, report_all, fq, shard_files, where,
           n_shards=2):
    """Copy ``shard_files[:n_shards]`` into ``where`` and unify them there;
    the four files' bytes."""
    where.mkdir()
    copies = []
    for p in shard_files[:n_shards]:
        copies.append(str(where / p.rsplit("/", 1)[1]))
        shutil.copy(p, copies[-1])
    params = params_cls(**PARAMS, report_all=report_all)
    params.query_sequences, params.out_file_name = [fq], "unified"
    unify_files(str(where / "unified"), params, copies, [fq])
    return {s: (where / ("unified" + s)).read_bytes() for s in SIDECARS}


@pytest.mark.parametrize("batch", [8192, 3, 1])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("report_all", [False, True])
def test_unify_writes_the_per_read_paths_bytes(mapped, tmp_path, monkeypatch,
                                               report_all, n_shards, batch):
    _, fq, files = mapped
    monkeypatch.setattr(mapwrap, "BATCH_READS", batch)
    with trace.span("test") as outer:
        got = _unify(mapwrap.unify_files, Parameters, report_all, fq,
                     files[report_all], tmp_path / "port", n_shards)
    want = _unify(jax_mapwrap.unify_files, JaxParameters, report_all, fq,
                  files[report_all], tmp_path / "jax", n_shards)
    assert got == want
    lines = got[""].decode().splitlines()
    names = [line.split(" ", 1)[0] for line in lines]
    assert len(set(names)) >= 10 and b"read9" in got[".meta.unmappedReadsLengths"]
    if report_all:  # some read has several lines
        assert len(names) > len(set(names))
    if n_shards == 2:  # some read has lines from both shards
        shard_of = {}
        for line in lines:
            fields = line.split(" ")
            read, contig = fields[0], fields[5]
            shard_of.setdefault(read, set()).add(contig[:2] in ("G2", "G3"))
        assert any(len(v) == 2 for v in shard_of.values())
    unify = [s for s in trace.spans()
             if s.name == "unify" and s.root == outer.id]
    assert len(unify) == 1
    assert unify[0].attrs["lines"] == len(lines)
    assert unify[0].attrs["mapq_batches"] == math.ceil(len(set(names)) / batch)
    assert 0 < unify[0].attrs["mapq_s"]


def test_each_read_matches_the_jax_packages_add_mapping_qualities(mapped):
    _, _, files = mapped
    by_read = {}
    for p in files[True]:
        with open(p) as f:
            for line in f:
                by_read.setdefault(line.split(" ", 1)[0], []).append(
                    line.rstrip("\n"))
    assert any(len(lines) > 1 for lines in by_read.values())
    for report_all in (False, True):
        params = Parameters(**PARAMS, report_all=report_all)
        jparams = JaxParameters(**PARAMS, report_all=report_all)
        for lines in by_read.values():
            assert (mapwrap.add_mapping_qualities(params, lines)
                    == jax_mapwrap.add_mapping_qualities(jparams, lines))
    assert mapwrap.add_mapping_qualities(params, []) == []


def _line(read_id="r1", read_len=5000, identity=90.0, intersection=40,
          sketch=600):
    return MappingLine(read_id=read_id, read_len=read_len, strand=1,
                       contig_id="c|kraken:taxid|1|X.1", contig_len=100000,
                       ref_start=10, ref_end=10 + read_len, identity=identity,
                       intersection=intersection, sketch_size=sketch).format()


BAD_READS = {
    "zero_sum": [_line(identity=100.0, intersection=0, sketch=1000)],
    "fields": [_line() + " 1"],
    "intersection_above_sketch": [_line(intersection=601)],
    "two_ids": [_line(), _line(read_id="r2")],
    "two_lengths": [_line(), _line(read_len=5001)],
    "too_short": [_line(read_len=16, intersection=0, sketch=1)],
}


@pytest.mark.parametrize("bad", sorted(BAD_READS))
def test_bad_reads_raise_naming_the_read(bad):
    params = Parameters(**PARAMS)
    good = [_line(read_id="r0", intersection=60)]
    with pytest.raises(ValueError, match="read r1"):
        mapwrap._with_mapping_qualities(params, [good, BAD_READS[bad]])
    with pytest.raises((AssertionError, ValueError)):
        jax_mapwrap.add_mapping_qualities(JaxParameters(**PARAMS),
                                          BAD_READS[bad])


def test_unify_raises_on_a_zero_sum_read(tmp_path):
    fq = str(tmp_path / "reads.fastq")
    rng = np.random.default_rng(7)
    write_reads_fastq(fq, [(random_genome(rng, 5000),)], prefix="r")
    shard_file = str(tmp_path / "out.0")
    with open(shard_file, "w") as f:
        f.write(_line(read_id="r0", identity=100.0, intersection=0,
                      sketch=1000) + "\n")
    params = Parameters(**PARAMS)
    with pytest.raises(ValueError, match="zero likelihood sum for read r0"):
        mapwrap.unify_files(str(tmp_path / "out"), params, [shard_file], [fq])
