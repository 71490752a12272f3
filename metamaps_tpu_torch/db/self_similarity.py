"""Taxonomy self-similarity precomputation — estimateSelfSimilarity.pl
equivalent.

Produces ``selfSimilarities.txt``: for each potential novel-species
attachment node N, the distribution P(best mapping identity | read length)
of error-free chunks from one mappable descendant (under one child of N)
mapped against the genomes under N's *other* children — a leave-one-out
estimate of how similar a novel genome attached at N would look.

Structure mirrors the reference's resumable job model
(estimateSelfSimilarity.pl modes prepareFromScratch :82 / doJobI :391 /
collect :472): `prepare` enumerates jobs, `run_job` executes one
(simulate chunks at lengths 2000..50000 step 1000 stride 1000, <=2000
chunks/length; map with the engine itself per chunk length, since the
window size derives from the read length), `collect` aggregates the
per-job histograms. Jobs write independent result files, so the fan-out
unit is the same as the reference's SGE array task — here runnable
in-process, via multiprocessing, or one-job-per-invocation on a cluster.

Counterpart: ``metamaps_tpu/db/self_similarity.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass, asdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..engine.em import load_relevant_taxon_info
from ..engine.index import SketchShard
from ..engine import mapper_oracle
from ..io.fasta import read_sequences
from ..params import Parameters
from ..taxonomy import Taxonomy
from ..ops.winnow import winnow_fast

# reference defaults (estimateSelfSimilarity.pl:36-43)
SIM_SIZE_FROM = 2000
SIM_SIZE_TO = 50000
SIM_SIZE_STEP = 1000
SIM_DELTA = 1000
TARGET_MAX_CHUNKS = 2000


@dataclass
class SelfSimJob:
    node: str  # attachment node
    child: str  # immediate child supplying the A genome
    a_taxon: str  # mappable descendant mapped as reads
    b_taxa: List[str]  # mappable descendants of the other children


def mappable_filtered_taxonomy(taxonomy: Taxonomy, mappable: Set[str]) -> Set[str]:
    """Nodes with at least one mappable descendant-or-self
    (taxTree::removeUnmappableParts)."""
    keep = set()
    for t in mappable:
        if taxonomy.know_node(t):
            keep.update(taxonomy.get_upward_nodes(t))
    return keep


def enumerate_attachment_nodes(taxonomy: Taxonomy, kept: Set[str]) -> List[str]:
    """Descendants (incl. self) of species/genus/family-ranked nodes having
    >1 (kept) child (taxTree.pm:863-896)."""
    out = set()
    for node_id in kept:
        rank = taxonomy.get_node(node_id).rank
        if rank in ("species", "genus", "family"):
            for cand in [node_id] + [
                d for d in taxonomy.descendants(node_id) if d in kept
            ]:
                children = [c for c in taxonomy.get_node(cand).children if c in kept]
                if len(children) > 1:
                    out.add(cand)
    return sorted(out)


def enumerate_jobs(taxonomy: Taxonomy, mappable: Set[str]) -> List[SelfSimJob]:
    """(taxTree::getSubComputationsForAttachment, taxTree.pm:898-944)"""
    kept = mappable_filtered_taxonomy(taxonomy, mappable)
    jobs: List[SelfSimJob] = []
    for node in enumerate_attachment_nodes(taxonomy, kept):
        children = sorted(c for c in taxonomy.get_node(node).children if c in kept)
        mappable_per_child = {}
        for c in children:
            cand = [c] + taxonomy.descendants(c)
            mappable_per_child[c] = sorted(t for t in cand if t in mappable)
            assert mappable_per_child[c], (node, c)
        for c in children:
            others = []
            for c2 in children:
                if c2 != c:
                    others.extend(mappable_per_child[c2])
            for a in mappable_per_child[c]:
                jobs.append(SelfSimJob(node, c, a, sorted(others)))
    return jobs


def prepare(db_dir: str, out_dir: str) -> List[SelfSimJob]:
    """Enumerate and persist jobs (mode prepareFromScratch)."""
    os.makedirs(out_dir, exist_ok=True)
    taxon_info = load_relevant_taxon_info(db_dir, set())
    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))
    jobs = enumerate_jobs(taxonomy, set(taxon_info))
    with open(os.path.join(out_dir, "jobs.json"), "w") as f:
        json.dump([asdict(j) for j in jobs], f, indent=1)
    return jobs


def load_jobs(out_dir: str) -> List[SelfSimJob]:
    with open(os.path.join(out_dir, "jobs.json")) as f:
        return [SelfSimJob(**d) for d in json.load(f)]


def _chunk_positions(contigs, lengths, delta, max_chunks, rng):
    """Chunk sampling per length (getChunkPositions,
    estimateSelfSimilarity.pl:769-841); sampling uses numpy RNG instead of
    Perl srand but follows the same start-rate thinning."""
    out = []  # (length, contig_idx, pos)
    for L in lengths:
        eligible = sum(
            max(0, (len(seq) - L) // delta + 1) for _, seq in contigs if len(seq) >= L
        )
        rate = 1.0 if eligible <= max_chunks else max_chunks / eligible
        for ci, (_, seq) in enumerate(contigs):
            for pos in range(0, len(seq) - L + 1, delta):
                if rate >= 1.0 or rng.random() <= rate:
                    out.append((L, ci, pos))
    return out


def job_contigs(taxon_info, job: SelfSimJob) -> Tuple[List[str], List[str]]:
    """Sorted (A, B) contig ID lists — the reference keys template reuse on
    exactly these (estimateSelfSimilarity.pl:206-210 computation_key)."""
    contigs_a = sorted(taxon_info[job.a_taxon])
    b: Set[str] = set()
    for t in job.b_taxa:
        b.update(taxon_info[t])
    return contigs_a, sorted(b)


def _load_db_contigs(db_dir: str, a_ids: Set[str], b_ids: Set[str]):
    a_contigs, b_contigs = [], []
    for name, seq in read_sequences(os.path.join(db_dir, "DB.fa")):
        if name in a_ids:
            a_contigs.append((name, seq))
        elif name in b_ids:
            b_contigs.append((name, seq))
    return a_contigs, b_contigs


def _map_chunks(
    a_contigs,
    b_contigs,
    chunk_items: List[Tuple[int, int, int]],
    percentage_identity: float,
):
    """Map (L, a_contig_idx, pos) chunks against the B genomes; returns
    {chunk_index: (best_identity_int, best_b_contig_index)} for mapped
    chunks (best-identity winner, as in processAlignments_oneRead,
    estimateSelfSimilarity.pl:525-560)."""
    b_index = {name: i for i, (name, _) in enumerate(b_contigs)}
    reference_size = sum(len(s) for _, s in b_contigs)
    shard_cache: Dict[int, SketchShard] = {}
    by_length: Dict[int, List[Tuple[int, int, int]]] = {}
    for idx, (L, ci, pos) in enumerate(chunk_items):
        by_length.setdefault(L, []).append((idx, ci, pos))

    out: Dict[int, Tuple[int, int]] = {}
    for L, items in sorted(by_length.items()):
        params = Parameters(
            kmer_size=16,
            min_read_length=L,
            percentage_identity=percentage_identity,
            reference_size=max(reference_size, 1),
        ).derive_window_size()
        w = params.window_size
        if w not in shard_cache:
            shard = SketchShard()
            parts = []
            for i, (name, seq) in enumerate(b_contigs):
                h, p, s = winnow_fast(seq, params.kmer_size, w)
                parts.append((h, p, s, i))
                shard.contig_names.append(name)
                shard.contig_lengths.append(len(seq))
            shard_cache[w] = shard.finalize(parts)
        shard = shard_cache[w]

        for idx, ci, pos in items:
            chunk = a_contigs[ci][1][pos : pos + L]
            ms = mapper_oracle.report_filter(
                mapper_oracle.map_read(shard, params, chunk), report_all=False
            )
            if not ms:
                continue
            best = max(ms, key=lambda m: m.nuc_identity)
            out[idx] = (
                int(best.nuc_identity + 0.5),
                b_index[shard.contig_names[best.ref_seqid]],
            )
    return out


def _write_job_outputs(out_dir, job_index, histogram, contigs_a, contigs_b,
                       chunks, read_results):
    os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
    with open(os.path.join(out_dir, "results", f"{job_index}.json"), "w") as f:
        json.dump({str(k): v for k, v in histogram.items()}, f)
    # per-chunk detail (the readInfo/readResults pair of doJobI,
    # estimateSelfSimilarity.pl:422-443) — enables template reuse
    with open(os.path.join(out_dir, "results", f"{job_index}.reads.json"), "w") as f:
        json.dump(
            {
                "contigs_a": contigs_a,
                "contigs_b": contigs_b,
                "chunks": [list(c) for c in chunks],
                "read_results": {
                    str(i): list(v) for i, v in sorted(read_results.items())
                },
            },
            f,
        )


def run_job(
    db_dir: str,
    job: SelfSimJob,
    out_dir: str,
    job_index: int,
    sim_from: int = SIM_SIZE_FROM,
    sim_to: int = SIM_SIZE_TO,
    sim_step: int = SIM_SIZE_STEP,
    sim_delta: int = SIM_DELTA,
    max_chunks: int = TARGET_MAX_CHUNKS,
    percentage_identity: float = 80.0,
):
    """Execute one leave-one-out mapping job; writes results/<i>.json with
    {chunkLength: {identityInt: count}} over mapped chunks, plus a
    results/<i>.reads.json per-chunk detail file for template reuse."""
    taxon_info = load_relevant_taxon_info(db_dir, set())
    contigs_a_list, contigs_b_list = job_contigs(taxon_info, job)
    a_contigs, b_contigs = _load_db_contigs(
        db_dir, set(contigs_a_list), set(contigs_b_list)
    )

    # deterministic per-A-genome seed (the reference records srand's seed in
    # the readInfo file for the same reproducibility, :419)
    rng = np.random.default_rng(zlib.crc32(";".join(contigs_a_list).encode()))
    lengths = list(range(sim_from, sim_to + 1, sim_step))
    chunks = _chunk_positions(a_contigs, lengths, sim_delta, max_chunks, rng)

    read_results = _map_chunks(a_contigs, b_contigs, chunks, percentage_identity)

    histogram: Dict[int, Dict[int, int]] = {}
    for idx, (ident, _bc) in read_results.items():
        L = chunks[idx][0]
        histogram.setdefault(L, {})[ident] = histogram.setdefault(L, {}).get(ident, 0) + 1

    _write_job_outputs(out_dir, job_index, histogram,
                       [n for n, _ in a_contigs], [n for n, _ in b_contigs],
                       chunks, read_results)
    return histogram


def _run_job_from_template(
    db_dir: str,
    job: SelfSimJob,
    out_dir: str,
    job_index: int,
    template_reads: dict,
    percentage_identity: float = 80.0,
):
    """Re-derive one job from a template job with a superset B genome set
    (doJobIFromTemplate, estimateSelfSimilarity.pl:842-1031): chunks whose
    template best hit lies inside the new B set keep their identity; chunks
    that hit a removed genome are remapped against the new B set; chunks the
    template never mapped stay unmapped. Untracked chunks fill the identity-0
    bucket (:1006-1017)."""
    taxon_info = load_relevant_taxon_info(db_dir, set())
    contigs_a_list, contigs_b_list = job_contigs(taxon_info, job)
    new_b: Set[str] = set(contigs_b_list)

    t_contigs_a: List[str] = template_reads["contigs_a"]
    t_contigs_b: List[str] = template_reads["contigs_b"]
    assert sorted(t_contigs_a) == contigs_a_list, "template A-contig mismatch"
    assert new_b <= set(t_contigs_b), "template B set must be a superset"
    chunks = [tuple(c) for c in template_reads["chunks"]]

    keep: Dict[int, Tuple[int, int]] = {}  # chunk idx -> (identity, b name idx)
    remap_idx: List[int] = []
    for si, (ident, bci) in template_reads["read_results"].items():
        idx = int(si)
        if t_contigs_b[bci] in new_b:
            keep[idx] = (ident, bci)
        else:
            remap_idx.append(idx)

    a_contigs, b_contigs = _load_db_contigs(
        db_dir, set(contigs_a_list), new_b
    )
    remapped = _map_chunks(
        a_contigs, b_contigs, [chunks[i] for i in remap_idx], percentage_identity
    )

    b_name_index = {n: i for i, (n, _) in enumerate(b_contigs)}
    read_results: Dict[int, Tuple[int, int]] = {}
    histogram: Dict[int, Dict[int, int]] = {}
    a_order = [n for n, _ in a_contigs]
    # template chunk ci indexes the template's A file order; remap against
    # identically-ordered A contigs, so indices carry over unchanged
    assert a_order == t_contigs_a, "A contig order differs from template"
    for idx, (ident, bci) in keep.items():
        read_results[idx] = (ident, b_name_index[t_contigs_b[bci]])
    for j, idx in enumerate(remap_idx):
        if j in remapped:
            read_results[idx] = remapped[j]
    for idx, (ident, _bc) in read_results.items():
        L = chunks[idx][0]
        histogram.setdefault(L, {})[ident] = histogram.setdefault(L, {}).get(ident, 0) + 1
    # identity-0 fill for chunks with no tracked result
    totals: Dict[int, int] = {}
    for L, _ci, _pos in chunks:
        totals[L] = totals.get(L, 0) + 1
    tracked: Dict[int, int] = {
        L: sum(h.values()) for L, h in histogram.items()
    }
    for L, n in totals.items():
        missing = n - tracked.get(L, 0)
        assert missing >= 0
        if missing:
            histogram.setdefault(L, {})[0] = histogram[L].get(0, 0) + missing

    _write_job_outputs(out_dir, job_index, histogram, a_order,
                       [n for n, _ in b_contigs], chunks, read_results)
    return histogram


def prepare_from_template(
    db_dir: str,
    out_dir: str,
    template_db_dir: str,
    template_out_dir: Optional[str] = None,
    percentage_identity: float = 80.0,
):
    """Derive self-similarity results for a reduced DB from a template DB's
    finished computation (mode prepareFromTemplate,
    estimateSelfSimilarity.pl:195-385). Exact (A, B) contig-set matches copy
    the template result; otherwise the template job with the same A set and
    the smallest superset B is reduced via :func:`_run_job_from_template`.
    Returns (jobs, n_copied, n_recomputed)."""
    if template_out_dir is None:
        template_out_dir = os.path.join(template_db_dir, "selfSimilarity")
    if not os.path.exists(os.path.join(template_db_dir, "selfSimilarities.txt")):
        raise RuntimeError(
            f"Template DB {template_db_dir} does not have self-similarity results"
        )
    template_jobs = load_jobs(template_out_dir)
    template_ti = load_relevant_taxon_info(template_db_dir, set())

    exact: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]], int] = {}
    a_to_b: Dict[Tuple[str, ...], List[Tuple[Set[str], int]]] = {}
    for ti_idx, tjob in enumerate(template_jobs):
        ca, cb = job_contigs(template_ti, tjob)
        key = (tuple(ca), tuple(cb))
        assert key not in exact, "duplicate template computation"
        exact[key] = ti_idx
        a_to_b.setdefault(tuple(ca), []).append((set(cb), ti_idx))

    reduced_ti = load_relevant_taxon_info(db_dir, set())
    # validity: every reduced contig must exist in the template (:265-268)
    template_contigs = {c for cs in template_ti.values() for c in cs}
    for cs in reduced_ti.values():
        for c in cs:
            if c not in template_contigs:
                raise RuntimeError(f"contig {c} not present in template DB")

    jobs = prepare(db_dir, out_dir)
    n_copied = n_recomputed = 0
    for i, job in enumerate(jobs):
        ca, cb = job_contigs(reduced_ti, job)
        key = (tuple(ca), tuple(cb))
        if key in exact:
            t = exact[key]
            os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
            for suffix in (".json", ".reads.json"):
                src = os.path.join(template_out_dir, "results", f"{t}{suffix}")
                if os.path.exists(src):
                    shutil.copy(
                        src, os.path.join(out_dir, "results", f"{i}{suffix}")
                    )
            n_copied += 1
            continue
        # closest template: same A, superset B, fewest extra genomes
        # (the reference's sort comparator at :359 is a no-op typo
        # `$a <=> $a`; we implement the intended min-distance choice)
        alternatives = [
            (len(bset) - len(cb), t)
            for bset, t in a_to_b.get(tuple(ca), [])
            if set(cb) <= bset
        ]
        if not alternatives:
            raise RuntimeError(
                f"no template computation covers job {i} (A={job.a_taxon})"
            )
        _, t = min(alternatives)
        reads_fn = os.path.join(template_out_dir, "results", f"{t}.reads.json")
        if not os.path.exists(reads_fn):
            raise RuntimeError(
                f"template job {t} has no reads detail file ({reads_fn}); "
                f"re-run the template computation"
            )
        with open(reads_fn) as f:
            template_reads = json.load(f)
        template_reads["read_results"] = {
            k: tuple(v) for k, v in template_reads["read_results"].items()
        }
        _run_job_from_template(
            db_dir, job, out_dir, i, template_reads, percentage_identity
        )
        n_recomputed += 1

    collect(db_dir, out_dir)
    return jobs, n_copied, n_recomputed


def collect(db_dir: str, out_dir: str, output_file: Optional[str] = None):
    """Aggregate per-job histograms into selfSimilarities.txt (doCollect,
    estimateSelfSimilarity.pl:1218-1370); missing job results are tolerated
    (resumability contract). Also writes the expected-genome-sizes sidecar."""
    jobs = load_jobs(out_dir)
    taxon_info = load_relevant_taxon_info(db_dir, set())
    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))

    per_node: Dict[int, Dict[str, List[Dict[int, float]]]] = {}
    genome_lengths: Dict[str, Dict[str, int]] = {}
    for i, job in enumerate(jobs):
        genome_lengths.setdefault(job.node, {})[job.a_taxon] = sum(
            taxon_info[job.a_taxon].values()
        )
        fn = os.path.join(out_dir, "results", f"{i}.json")
        if not os.path.exists(fn):
            continue
        with open(fn) as f:
            hist = {int(k): {int(i2): c for i2, c in v.items()}
                    for k, v in json.load(f).items()}
        for L, h in hist.items():
            s = sum(h.values())
            if not s:
                continue
            per_node.setdefault(L, {}).setdefault(job.node, []).append(
                {k: v / s for k, v in h.items()}
            )

    if output_file is None:
        output_file = os.path.join(db_dir, "selfSimilarities.txt")
    with open(output_file, "w") as out:
        for L in sorted(per_node):
            for node in sorted(per_node[L]):
                combined: Dict[int, float] = {}
                for h in per_node[L][node]:
                    for k, v in h.items():
                        combined[k] = combined.get(k, 0.0) + v
                s = sum(combined.values())
                descendants_with_genomes = sorted(
                    d for d in taxonomy.descendants(node) if d in taxon_info
                )
                first = True
                for k in sorted(combined):
                    src = ";".join(descendants_with_genomes) if first else ""
                    rank = taxonomy.get_node(node).rank if first else ""
                    name = taxonomy.get_node(node).scientific_name if first else ""
                    out.write(
                        f"{node}\t{L}\t{k}\t{combined[k]/s:.10g}\t{src}\t{rank}\t{name}\n"
                    )
                    first = False

    with open(output_file + ".expectedGenomeSizes", "w") as out:
        out.write("targetNode\texpectedGenomeSize\tsourceNodes\tsourceGenomeSizes\n")
        for node in sorted(genome_lengths):
            sources = sorted(genome_lengths[node])
            lengths = [genome_lengths[node][s] for s in sources]
            out.write(
                f"{node}\t{np.mean(lengths):.10g}\t{';'.join(sources)}\t"
                f"{';'.join(map(str, lengths))}\n"
            )
    return output_file


def estimate_self_similarity(db_dir: str, out_dir: Optional[str] = None, **job_kwargs):
    """Run prepare + all jobs + collect in-process (small DBs / tests)."""
    if out_dir is None:
        out_dir = os.path.join(db_dir, "selfSimilarity")
    jobs = prepare(db_dir, out_dir)
    for i, job in enumerate(jobs):
        run_job(db_dir, job, out_dir, i, **job_kwargs)
    return collect(db_dir, out_dir)
