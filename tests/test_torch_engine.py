"""The port's engine and CLI vs the JAX package.

- ``TorchMapperEngine(device="cpu")`` against ``JaxMapperEngine``, the JAX
  package's serial oracle and the port's copy of it, on the cases of
  tests/test_mapper_jax.py (clean, noisy, adversarial, mixed read-length
  buckets, the protein alphabet): every ReadMapping must be equal;
- the port's ``mapDirectly`` + ``classify`` must write byte-identical
  mapping, ``.meta``, ``.meta.unmappedReadsLengths`` and ``.EM.*`` files to
  the JAX package's CLI with its serial oracle engine (which the JAX
  package's own tests pin to its device engine);
- the main-path engine refuses to run without CUDA unless ``device="cpu"``
  is given."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu.engine import mapper_oracle as jax_oracle
from metamaps_tpu.engine.index import SketchShard
from metamaps_tpu.engine.mapper_jax import JaxMapperEngine
from metamaps_tpu.ops.winnow import winnow_np
from metamaps_tpu.params import Parameters
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.engine import mapper_oracle as port_oracle
from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine
from metamaps_tpu_torch.ops import l1 as l1_module

from util_db import make_mini_db, write_reads_fastq
from util_sim import random_genome, revcomp, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)


def fields(mappings):
    """ReadMappings of either package as comparable tuples (exact floats)."""
    return [dataclasses.astuple(m) for m in mappings]


def build_shard(genomes, params):
    shard = SketchShard()
    parts = []
    for i, g in enumerate(genomes):
        h, p, s = winnow_np(g, params.kmer_size, params.window_size,
                            params.alphabet_size)
        parts.append((h, p, s, i))
        shard.contig_names.append(f"C{i}|kraken:taxid|{1000+i}|X{i}.1")
        shard.contig_lengths.append(len(g))
    return shard.finalize(parts)


def _dna_case(buckets):
    rng = np.random.default_rng(33)
    genomes = [random_genome(rng, 50000) for _ in range(3)]
    params = Parameters(kmer_size=16, window_size=16, min_read_length=2000,
                        percentage_identity=80.0)
    if buckets is None:  # clean, noisy and adversarial reads
        seqs = [r[0] for r in sample_reads(rng, genomes, 12, min_len=2000,
                                           max_len=7000, sub=0.0)]
        seqs += [r[0] for r in sample_reads(rng, genomes, 12, min_len=2000,
                                            max_len=7000, sub=0.08)]
        g = genomes[0]
        seqs += [
            np.tile(g[1000:1400], 8),  # tandem repeat read
            np.concatenate([g[5000:7000], g[30000:32000]]),  # chimera
            random_genome(rng, 3000),  # alien
            g[10000:14096],  # exact
            revcomp(g[20000:24096]),  # exact revcomp
            np.concatenate([g[8000:10000], revcomp(g[8000:10000])]),
        ]
    else:  # mixed lengths over two buckets
        seqs = [r[0] for r in sample_reads(rng, genomes, 12, min_len=2000,
                                           max_len=2100, sub=0.05)]
        seqs += [r[0] for r in sample_reads(rng, genomes, 4, min_len=6000,
                                            max_len=7500, sub=0.05)]
    return genomes, params, seqs


def _protein_case():
    rng = np.random.default_rng(77)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    genomes = [rng.choice(aa, size=20000) for _ in range(2)]
    params = Parameters(kmer_size=5, window_size=16, min_read_length=500,
                        percentage_identity=80.0, alphabet_size=20)
    seqs = []
    for i in range(6):
        g = genomes[i % 2]
        pos = int(rng.integers(0, len(g) - 3000))
        r = g[pos: pos + 3000].copy()
        nm = int(0.05 * len(r)) if i % 2 else 0
        if nm:
            idx = rng.integers(0, len(r), nm)
            r[idx] = aa[rng.integers(0, 20, nm)]
        seqs.append(r)
    seqs.append(rng.choice(aa, size=2000))
    return genomes, params, seqs


@pytest.mark.parametrize("case", ["dna", "mixed_lengths", "protein"])
def test_engine_matches_jax_engine_and_oracles(case):
    if case == "protein":
        genomes, params, seqs = _protein_case()
        buckets = (4096,)
    else:
        buckets = (2048, 8192) if case == "mixed_lengths" else None
        genomes, params, seqs = _dna_case(buckets)
    shard = build_shard(genomes, params)
    engine = TorchMapperEngine(shard, params, device="cpu",
                               read_len_buckets=buckets)
    got = [fields(m) for m in engine.map_reads(seqs)]
    want_jax = JaxMapperEngine(shard, params,
                               read_len_buckets=buckets).map_reads(seqs)
    n_mapped = 0
    for i, seq in enumerate(seqs):
        want = fields(jax_oracle.map_read(shard, params, seq))
        assert got[i] == want, f"read {i} vs JAX oracle"
        assert got[i] == fields(port_oracle.map_read(shard, params, seq))
        assert got[i] == fields(want_jax[i]), f"read {i} vs JaxMapperEngine"
        n_mapped += bool(want)
    assert n_mapped >= len(seqs) - 2
    if case == "protein":
        # k=5 makes minimumHits exceed the JAX detector's shift limit of 32,
        # so the JAX engine hands every read to the oracle; the port has no
        # such limit and runs its own L1/L2 path on them, with the same lines
        sizes = [port_oracle.sketch_read(seq, params.kmer_size,
                                         params.window_size,
                                         params.alphabet_size)[0].size
                 for seq in seqs]
        minhits = l1_module.minhits_table(max(sizes), params.kmer_size,
                                          params.percentage_identity)
        assert min(int(minhits[s]) for s in sizes) > 32
    assert engine.stats["oracle_fallbacks"] == 0
    assert engine.stats["l2_candidates"] > 0


@pytest.fixture(scope="module")
def mini_db(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    db = str(root / "DB")
    rng = np.random.default_rng(42)
    genomes, _, _ = make_mini_db(db, rng)
    reads = sample_reads(rng, genomes, 40, min_len=2500, max_len=6000,
                         sub=0.06)
    reads.append((random_genome(rng, 500), -1, 0, 1))  # too short
    reads.append((random_genome(rng, 300), -1, 0, 1))
    reads.append((random_genome(rng, 4000), -1, 0, 1))  # alien
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)
    return root, db, fq


OUTPUT_SUFFIXES = (
    "", ".meta", ".meta.unmappedReadsLengths", ".EM", ".EM.WIMP",
    ".EM.reads2Taxon", ".EM.reads2Taxon.krona",
    ".EM.lengthAndIdentitiesPerMappingUnit", ".EM.contigCoverage",
    ".EM.evidenceUnknownSpecies",
)


def test_cli_outputs_identical_to_jax_package(mini_db):
    root, db, fq = mini_db
    ref = os.path.join(db, "DB.fa")
    out_jax = str(root / "jax.mappings")
    out_port = str(root / "port.mappings")
    assert jax_cli_main(["mapDirectly", "--reference", ref, "--query", fq,
                         "--output", out_jax, "--all", "--minReadLen", "2000",
                         "--mapping-engine", "oracle"]) == 0
    assert jax_cli_main(["classify", "--DB", db, "--mappings", out_jax]) == 0
    stats = {}
    assert port_cli_main(["mapDirectly", "--reference", ref, "--query", fq,
                          "--output", out_port, "--all", "--minReadLen",
                          "2000", "--mapping-engine", "torch", "--device",
                          "cpu"], engine_stats=stats) == 0
    assert port_cli_main(["classify", "--DB", db, "--mappings", out_port,
                          "--device", "cpu"]) == 0
    assert stats["reads_total"] == 43 and stats["reads_mappable"] == 41
    assert stats["oracle_fallbacks"] == 0 and stats["l2_candidates"] >= 40
    for suffix in OUTPUT_SUFFIXES:
        with open(out_jax + suffix) as a, open(out_port + suffix) as b:
            assert a.read() == b.read(), f"{suffix or 'mappings'} differs"


def test_main_path_requires_cuda(mini_db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    params = Parameters(kmer_size=16, window_size=16)
    shard = build_shard([random_genome(rng, 5000)], params)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMapperEngine(shard, params)
    assert TorchMapperEngine(shard, params, device="cpu").device.type == "cpu"
    root, db, fq = mini_db
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli_main(["mapDirectly", "--reference", os.path.join(db, "DB.fa"),
                       "--query", fq, "--output", str(root / "no_cuda")])
