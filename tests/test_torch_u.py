"""The port's ``classifyU`` vs the JAX package's.

Both packages run ``mapDirectly`` -> ``classify`` -> ``classifyU`` on the
setup of tests/test_u_pipeline.py (a seeded mini database with a synthetic
``selfSimilarities.txt`` for one genus node, reads from the database and
from a novel relative of one genome): the JAX package with its serial
oracle engine and host EM, the port with its torch engine and EM rounds on
the CPU. All eight U output files must be byte-identical. The port's
vectorised U mapping qualities must equal its scalar oracle on every read
of that run."""
import copy
import os

import numpy as np
import pytest

from metamaps_tpu.cli import main as jax_cli_main
from metamaps_tpu_torch.cli import main as port_cli_main
from metamaps_tpu_torch.engine import u
from metamaps_tpu_torch.engine.u_helper import (
    IdentityManager,
    IdentityReadLengthHistogram,
    TreeAdjustedIdentities,
)
from metamaps_tpu_torch.io.mappings import iter_reads_grouped
from metamaps_tpu_torch.taxonomy import Taxonomy

from util_db import make_mini_db, write_reads_fastq
from util_sim import mutate, sample_reads
from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

U_FILES = (".mapQ_U", ".U.WIMP", ".U.WIMP.absoluteClassifiedAt",
           ".U.reads2Taxon", ".U.lengthAndIdentitiesPerTaxonID",
           ".U.shiftedHistogramsPerTaxonID", ".EM2U.details",
           ".EM2U.summary")
MIN_READS = "3"


@pytest.fixture(scope="module")
def u_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_u")
    db = str(root / "DB")
    rng = np.random.default_rng(1234)
    genomes, _, _ = make_mini_db(db, rng, n_genomes=3, genome_len=60000)
    with open(os.path.join(db, "selfSimilarities.txt"), "w") as f:
        for node, center in [("100", 88)]:
            for rl in (2000, 5000, 10000, 20000):
                ps = {center - 4: 0.1, center - 2: 0.2, center: 0.4,
                      center + 2: 0.2, center + 4: 0.1}
                for idty, p in ps.items():
                    f.write(f"{node}\t{rl}\t{idty}\t{p}\t\n")
    reads = sample_reads(rng, genomes, 40, min_len=2500, max_len=6000,
                         sub=0.04)
    novel_genome = mutate(rng, genomes[0], sub=0.12)
    reads += sample_reads(rng, [novel_genome], 12, min_len=2500,
                          max_len=6000, sub=0.04)
    fq = str(root / "reads.fastq")
    write_reads_fastq(fq, reads)

    outs = {}
    for pkg, cli, engine, device in (
            ("jax", jax_cli_main, ["--mapping-engine", "oracle"], []),
            ("port", port_cli_main, ["--mapping-engine", "torch"],
             ["--device", "cpu"])):
        out = outs[pkg] = str(root / f"{pkg}.mappings")
        assert cli(["mapDirectly", "--reference", os.path.join(db, "DB.fa"),
                    "--query", fq, "--output", out, "--all", "--minReadLen",
                    "2000", *engine, *device]) == 0
        assert cli(["classify", "--DB", db, "--mappings", out,
                    "--minreads", MIN_READS, *device]) == 0
        assert cli(["classifyU", "--DB", db, "--mappings", out,
                    "--minreads", MIN_READS]) == 0
    return db, outs


@pytest.mark.parametrize("suffix", U_FILES)
def test_u_outputs_identical_to_jax_package(u_runs, suffix):
    _, outs = u_runs
    with open(outs["jax"] + suffix) as a, open(outs["port"] + suffix) as b:
        want, got = a.read(), b.read()
    assert want, f"{suffix} is empty"
    assert got == want, f"{suffix} differs"


def test_u_mapq_vectorised_equals_scalar(u_runs):
    """The tolerance is the JAX package's own for the same pair
    (tests/test_u_pipeline.py): 1e-12 absolute plus 1e-9 relative."""
    db, outs = u_runs
    mapped = outs["port"]
    taxonomy = Taxonomy(os.path.join(db, "taxonomy"))
    ih = IdentityReadLengthHistogram()
    ih.read_from_em_output(mapped + ".EM.lengthAndIdentitiesPerMappingUnit",
                           u.get_min_max_identities(mapped), int(MIN_READS))
    taxa = set()
    for read_lines in iter_reads_grouped(mapped):
        taxa.update(u.extract_taxon_id(l.split(" ")[5]) for l in read_lines)
    tai = TreeAdjustedIdentities()
    tai.read_from_file(os.path.join(db, "selfSimilarities.txt"), taxa,
                       taxonomy)
    im = IdentityManager(ih, tai)
    upward = {t: [n for n in taxonomy.get_upward_nodes(t)
                  if tai.node_for_indirect_attachment(n)] for t in taxa}
    n_reads = n_indirect = 0
    for read_lines in iter_reads_grouped(mapped):
        locs = u.get_mapping_locations_u(upward, read_lines)
        vec, scalar = copy.deepcopy(locs), copy.deepcopy(locs)
        u.compute_u_mapping_qualities(vec, im, 16)
        u._compute_u_mapping_qualities_scalar(scalar, im, 16)
        for a, b in zip(scalar, vec, strict=True):
            assert abs(a.mapq - b.mapq) <= 1e-12 + 1e-9 * abs(a.mapq)
        n_reads += 1
        n_indirect += sum(not l.direct for l in locs)
    assert n_reads >= 40 and n_indirect > 0
