"""Command-line interface of the port.

Counterpart: ``metamaps_tpu/cli.py``. The reference's five core
subcommands run through the port: ``index``, ``mapDirectly`` (single shard,
the memory-bounded shard loop, or ``--mesh shard=S,data=D``: the index
partitioned by contigs over S x D devices, ``--meshBuckets``,
``--meshRows`` and ``--meshProgress`` as in the JAX package; with
``--device cuda`` it needs S * D cards, with ``--device cpu`` every rank is
on the CPU; the ranks run in turn in one thread), ``mapAgainstIndex`` (the stored shards
of an ``index``), ``classify`` (EM rounds in float64 on ``--device``;
``--emBackend sharded`` over every visible card, or one CPU rank, and
``auto`` as the JAX package picks) and
``classifyU`` (host code, as in the JAX package). The database and
simulation tools run through the port too: ``annotate``, ``buildDB``,
``validateDB``, ``DBinfo``, ``selfSimilarity`` (the serial host engine per
chunk, as in the JAX package), ``shortenContigIDs``,
``addTaxonIDToFasta``, ``synthDB``, ``simulate``, ``experiments``,
``buildTruth``, ``truthDataset``, ``extractReads``, ``firstQuartileScore``,
``compareMappings`` and ``benchmarkInference``; ``simulate --action
inference`` and ``experiments`` map with ``--engine`` (``torch`` or
``oracle``) and run the EM on ``--device``, and raise without CUDA unless
``--device cpu`` is given. The host tools that read classify's output or
export the database run through the port too: ``geneLevelAnalysis``,
``filterWIMP``, ``convertDB``, ``splitEggNog``, ``evaluateExternal``
(``--plots``: the paper figure set), ``plotIdentities`` and
``downloadRefSeq``. Every subcommand and option of the JAX package's CLI is
here, with its defaults.

    python -m metamaps_tpu_torch mapDirectly --reference DB/DB.fa \\
        --query reads.fastq --output out --all
    python -m metamaps_tpu_torch mapDirectly --reference DB/DB.fa \\
        --query reads.fastq --output out --all --mesh shard=4,data=2
    python -m metamaps_tpu_torch index --reference DB/DB.fa --index idx/DB
    python -m metamaps_tpu_torch mapAgainstIndex --index idx/DB \\
        --query reads.fastq --output out --all
    python -m metamaps_tpu_torch classify --DB DB --mappings out \\
        [--emBackend torch|numpy|sharded|auto]
    python -m metamaps_tpu_torch classifyU --DB DB --mappings out
    python -m metamaps_tpu_torch synthDB --out DB --genera 36 --seed 42
    python -m metamaps_tpu_torch experiments --DB DB --store store \\
        --name acc --nReads 1500 --holdout auto6 --seed 11
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from .device import require_cuda
from .engine.em import EM_BACKENDS, do_em
from .engine.mapwrap import ENGINES
from .io.fasta import total_file_size
from .params import Parameters

#: the reference's five subcommands; every other one is a database or
#: simulation tool (:func:`_run_tool`)
CORE_COMMANDS = ("index", "mapDirectly", "mapAgainstIndex", "classify",
                 "classifyU")


def _add_sketch_args(p: argparse.ArgumentParser):
    # short aliases mirror the reference (parseCmdArgs.hpp:58-79)
    p.add_argument("--reference", "-r", required=True, help="reference FASTA (DB.fa)")
    p.add_argument("--kmer", "-k", type=int, default=None, help="k-mer size (default 16)")
    p.add_argument("--pval", "-p", type=float, default=None, help="p-value cutoff (default 1e-3)")
    p.add_argument("--minReadLen", "-m", type=int, default=None, help="minimum read length (default 1000)")
    p.add_argument("--perc_identity", "--pi", dest="pi", type=float, default=None,
                   help="identity cutoff %% (default 80)")
    p.add_argument("--window", "-w", type=int, default=None, help="window size (default: from p-value)")
    p.add_argument("--maxmemory", "--mm", type=int, default=None, help="memory budget in GB")


def _add_query_args(p: argparse.ArgumentParser):
    p.add_argument("--query", "-q", required=True, help="reads FASTA/FASTQ (comma-separated list allowed)")
    p.add_argument("--output", "-o", required=True, help="output prefix (comma-separated list allowed)")
    p.add_argument("--all", action="store_true", help="report all mappings, not just the top band")
    p.add_argument("--threads", "-t", type=int, default=1,
                   help="host-side winnowing threads for the index build")
    p.add_argument("--mapping-engine", choices=ENGINES, default="torch",
                   help="batched torch engine (default) or serial host "
                   "engine (oracle)")
    p.add_argument("--profile", action="store_true",
                   help="per-phase torch engine seconds on stderr, one line "
                   "per shard and query file (on a card, the stream time "
                   "between CUDA events at each phase's edges)")


def _add_device_arg(p: argparse.ArgumentParser, what: str):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=f"device of the {what}; it raises when CUDA is "
                   "absent unless cpu is given")


def _sketch_params(args) -> Parameters:
    p = Parameters()
    p.ref_sequences = [args.reference]
    p.reference_size = total_file_size(p.ref_sequences)
    p.alphabet_size = 4
    p.maximum_memory = int(math.pow(1024, 3) * args.maxmemory) if args.maxmemory else 0
    p.kmer_size = args.kmer if args.kmer is not None else 16
    p.p_value = args.pval if args.pval is not None else 1e-3
    p.min_read_length = args.minReadLen if args.minReadLen is not None else 1000
    p.percentage_identity = args.pi if args.pi is not None else 80.0
    if args.window is not None:
        p.window_size = args.window
        p.derive_window_size(window_size_given=True)
    else:
        p.derive_window_size(window_size_given=False)
    return p


def _query_params(params: Parameters, args) -> None:
    """The query-side parameters of mapDirectly and mapAgainstIndex."""
    params.query_sequences = [args.query]
    params.out_file_name = args.output
    params.report_all = bool(args.all)
    params.threads = args.threads
    params.engine = args.mapping_engine


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="metamaps_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_idx = sub.add_parser("index", help="build index")
    _add_sketch_args(p_idx)
    p_idx.add_argument("--index", "-i", required=True, help="index output prefix")

    p_map = sub.add_parser("mapDirectly", help="map reads (index built on the fly)")
    _add_sketch_args(p_map)
    _add_query_args(p_map)
    _add_device_arg(p_map, "torch engine")
    p_map.add_argument(
        "--mesh", default=None, metavar="shard=S,data=D",
        help="map over a device mesh: index contig-partitioned over S "
        "blocks, each block's reads split over D ranks (needs S*D devices: "
        "cuda:0..S*D-1, or S*D ranks on the host with --device cpu); "
        "outputs are unified per read exactly as in the memory-bounded "
        "shard loop. The ranks run one after another in one thread, so "
        "the mesh is no faster than one device on any number of cards",
    )
    p_map.add_argument(
        "--meshBuckets", default=None, metavar="L1,L2,...",
        help="override the mesh engines' read-length buckets (each "
        "bucket's capacities derive from its length; default the torch "
        "engine's own)",
    )
    p_map.add_argument(
        "--meshRows", type=int, default=None,
        help="reads per device per mesh dispatch (default 32)",
    )
    p_map.add_argument(
        "--meshProgress", action="store_true",
        help="print time-stamped mesh phase progress to stderr",
    )

    p_mai = sub.add_parser("mapAgainstIndex", help="map reads against a stored index")
    p_mai.add_argument("--index", "-i", required=True, help="index prefix")
    _add_query_args(p_mai)
    _add_device_arg(p_mai, "torch engine")

    for name in ("classify", "classifyU"):
        p_c = sub.add_parser(name, help=(
            "EM composition estimation + per-read taxa" if name == "classify"
            else "EM-U novel-species analysis on classify's output"))
        p_c.add_argument("--DB", required=True, help="database directory")
        p_c.add_argument("--mappings", required=True,
                         help="mappings file from mapDirectly/mapAgainstIndex")
        p_c.add_argument("--minreads", type=int, default=10000)
        p_c.add_argument("--threads", "-t", type=int, default=1)
        if name == "classify":
            p_c.add_argument("--emBackend", choices=EM_BACKENDS, default="torch",
                             help="EM round backend: torch = float64 rounds on "
                             "--device (default), numpy = host float64 (parity "
                             "path), sharded = float64 rounds data-parallel over "
                             "every visible card (one rank with --device cpu) "
                             "with summed statistics, auto = torch for very "
                             "large mapping tables on a card, else numpy")
            _add_device_arg(p_c, "EM rounds")
    _add_tool_parsers(sub)
    return parser


def _add_tool_parsers(sub) -> None:
    """The database, simulation and analysis subcommands, with the JAX
    package's arguments (``metamaps_tpu/cli.py:134-330``); ``experiments``
    and ``simulate`` take the port's ``--engine`` and ``--device``."""
    p_ex = sub.add_parser(
        "experiments",
        help="run a full simulation experiment matrix: reads x DB variants "
        "(full + leave-out) x tools, with a resumable store, aggregate "
        "accuracy/composition tables and comparison plots",
    )
    p_ex.add_argument("--DB", required=True)
    p_ex.add_argument("--store", required=True, help="experiment store directory")
    p_ex.add_argument("--name", required=True, help="experiment name")
    p_ex.add_argument("--nReads", type=int, default=300)
    p_ex.add_argument("--holdout", default=None,
                      help="comma-separated taxa removed in a leave-out DB "
                      "variant, or autoN for N random taxa")
    p_ex.add_argument("--tools", default="metamaps",
                      help="comma list of metamaps,kraken2,centrifuge "
                      "(competitors that are not installed are recorded as "
                      "skipped; a failed metamaps run fails the command)")
    p_ex.add_argument("--seed", type=int, default=0)
    p_ex.add_argument("--meanLength", type=int, default=5000)
    p_ex.add_argument("--accuracy", type=float, default=0.88)
    p_ex.add_argument("--minReadLen", type=int, default=2000)
    _add_engine_args(p_ex)

    p_sdb = sub.add_parser(
        "synthDB",
        help="write a synthetic database directory (full DB-dir contract) "
        "at realistic taxonomy scale for accuracy experiments",
    )
    p_sdb.add_argument("--out", required=True)
    p_sdb.add_argument("--genera", type=int, default=36)
    p_sdb.add_argument("--speciesPerGenus", type=int, default=3)
    p_sdb.add_argument("--genomeLen", type=int, default=120_000)
    p_sdb.add_argument("--divergence", type=float, default=0.08)
    p_sdb.add_argument("--seed", type=int, default=0)

    p_sim = sub.add_parser("simulate", help="simulate reads / reduced DBs / evaluate an inference run")
    p_sim.add_argument("--action", choices=["reads", "reducedDB", "inference", "evaluate"], required=True)
    p_sim.add_argument("--DB", required=True)
    p_sim.add_argument("--out", required=True, help="output prefix (reads/inference/evaluate) or directory (reducedDB)")
    p_sim.add_argument("--nReads", type=int, default=1000)
    p_sim.add_argument("--meanLength", type=int, default=5000)
    p_sim.add_argument("--accuracy", type=float, default=0.88)
    p_sim.add_argument("--seed", type=int, default=0)
    p_sim.add_argument("--removeTaxa", default=None, help="comma-separated taxa dropped by action reducedDB")
    p_sim.add_argument("--reads", default=None, help="FASTQ for action inference")
    p_sim.add_argument("--truth", default=None, help="truth table for action evaluate")
    p_sim.add_argument("--mappings", default=None, help="mappings prefix for action evaluate")
    _add_engine_args(p_sim)

    p_tr = sub.add_parser("buildTruth", help="derive a per-read truth table from read IDs + an accession->taxon table")
    p_tr.add_argument("--reads", required=True, help="FASTQ/FASTA whose read IDs encode source accessions")
    p_tr.add_argument("--accessions", required=True, help="accession<TAB>taxonID table")
    p_tr.add_argument("--pattern", default=None, help="regex whose group 1 extracts the accession from a read ID")
    p_tr.add_argument("--DB", default=None, help="project truth into this DB's taxonomy (truth within the DB)")
    p_tr.add_argument("--output", required=True)

    p_td = sub.add_parser(
        "truthDataset",
        help="dataset-specific truth builders (truthForCAMI/Zymo/HMP): "
        "per-read truth + per-level distribution from gold-standard "
        "mappings or alignments",
    )
    p_td.add_argument("--dataset", choices=["cami", "zymo", "hmp"], required=True)
    p_td.add_argument("--output", required=True, help="output prefix")
    p_td.add_argument("--DB", default=None, help="DB dir (for the taxonomy-projected distribution)")
    p_td.add_argument("--mapping", default=None, help="CAMI reads_mapping.tsv")
    p_td.add_argument("--reference", default=None, help="Zymo reference FASTA (tx<taxid>| contigs)")
    p_td.add_argument("--alignments", default=None, help="SAM alignments (zymo/hmp)")
    p_td.add_argument("--gi2taxon", default=None, help="gi<TAB>taxonID table (hmp)")
    p_td.add_argument("--reads", default=None, help="FASTQ of all reads (unaligned reads get taxon 0)")

    p_xr = sub.add_parser("extractReads", help="extract reads by ID list or by assigned taxon subtree")
    p_xr.add_argument("--reads", required=True)
    p_xr.add_argument("--ids", default=None, help="file with one read ID per line")
    p_xr.add_argument("--r2t", default=None, help="reads2Taxon file (with --DB and --target)")
    p_xr.add_argument("--DB", default=None)
    p_xr.add_argument("--target", default=None, help="taxon ID whose subtree's reads to extract ('0' = unassigned)")
    p_xr.add_argument("--mode", choices=["records", "sortedFasta", "lengthDistribution"], default="records")
    p_xr.add_argument("--output", required=True)

    p_fq = sub.add_parser("firstQuartileScore", help="first-quartile base quality of a FASTQ")
    p_fq.add_argument("--fastq", required=True)

    p_sc = sub.add_parser("shortenContigIDs", help="rewrite contig IDs as C<i>|kraken:taxid|… with a mapping table")
    p_sc.add_argument("--input", required=True)
    p_sc.add_argument("--output", required=True)
    p_sc.add_argument("--mapping", required=True)

    p_eg = sub.add_parser("splitEggNog", help="split a protein FASTA for annotation jobs / collect annotations")
    p_eg.add_argument("--action", choices=["split", "submit", "collect"], required=True)
    p_eg.add_argument("--input", required=True, help="protein FASTA (split) / ignored otherwise")
    p_eg.add_argument("--output", required=True, help="output prefix; collect writes the merged table here")
    p_eg.add_argument("--targetChars", type=int, default=None)
    p_eg.add_argument("--cmd", default=None, help="annotation command template with {input}/{output}")

    p_at = sub.add_parser("addTaxonIDToFasta", help="append kraken:taxid|<id>| to every contig ID")
    p_at.add_argument("--input", required=True)
    p_at.add_argument("--output", required=True)
    p_at.add_argument("--taxonID", required=True)

    p_bdb = sub.add_parser("buildDB", help="build a database directory from annotated FASTAs")
    p_bdb.add_argument("--DB", required=True, help="output database directory")
    p_bdb.add_argument("--FASTAs", required=True, help="comma-separated annotated FASTA files")
    p_bdb.add_argument("--taxonomy", required=True, help="source NCBI taxonomy directory")
    p_bdb.add_argument("--shuffle", action="store_true", help="shuffle contig order")
    p_bdb.add_argument("--gff", default=None, help="comma-separated GFF annotation files -> DB_annotations.txt")
    p_bdb.add_argument("--proteins", default=None, help="comma-separated protein FASTAs -> DB_proteins.fa (deduplicated)")

    p_ann = sub.add_parser("annotate", help="annotate genomes with kraken:taxid contig IDs (+x pseudo-nodes)")
    p_ann.add_argument("--genomes", required=True,
                       help="comma-separated fasta=taxonID pairs, e.g. g1.fa=562,g2.fa=562")
    p_ann.add_argument("--output", required=True, help="combined annotated FASTA")
    p_ann.add_argument("--taxonomy", required=True, help="taxonomy directory (x-nodes appended)")

    p_val = sub.add_parser("validateDB", help="check DB integrity")
    p_val.add_argument("--DB", required=True)

    p_info = sub.add_parser("DBinfo", help="database statistics")
    p_info.add_argument("--DB", required=True)

    p_ss = sub.add_parser("selfSimilarity", help="precompute selfSimilarities.txt "
                          "(the serial host engine maps each chunk)")
    p_ss.add_argument("--DB", required=True)
    p_ss.add_argument("--mode", choices=["prepare", "prepareFromTemplate", "runJob", "collect", "all"], default="all")
    p_ss.add_argument("--templateDB", default=None)
    p_ss.add_argument("--jobI", type=int, default=None)
    p_ss.add_argument("--simFrom", type=int, default=None)
    p_ss.add_argument("--simTo", type=int, default=None)
    p_ss.add_argument("--simStep", type=int, default=None)
    p_ss.add_argument("--maxChunks", type=int, default=None,
                      help="cap on sampled chunks per length per job "
                      "(reference default 2000, "
                      "estimateSelfSimilarity.pl:36-43)")

    p_gla = sub.add_parser("geneLevelAnalysis", help="functional profile from best mappings x gene annotations")
    p_gla.add_argument("--DB", required=True)
    p_gla.add_argument("--mappings", required=True)

    p_fw = sub.add_parser("filterWIMP", help="drop WIMP entries with low median identity")
    p_fw.add_argument("--DB", required=True)
    p_fw.add_argument("--mappings", required=True)
    p_fw.add_argument("--identityThreshold", type=float, default=0.8)

    p_cv = sub.add_parser("convertDB", help="export DB for kraken/centrifuge/mash")
    p_cv.add_argument("--DB", required=True)
    p_cv.add_argument("--to", choices=["kraken", "centrifuge", "mash"], required=True)
    p_cv.add_argument("--output", required=True)

    p_cmp = sub.add_parser("compareMappings", help="diff two mappings files")
    p_cmp.add_argument("fileA")
    p_cmp.add_argument("fileB")
    p_cmp.add_argument("--posTolerance", type=int, default=0)

    p_bi = sub.add_parser("benchmarkInference", help="per-read accuracy vs a truth table")
    p_bi.add_argument("--mappings", required=True)
    p_bi.add_argument("--truth", required=True)

    p_ee = sub.add_parser(
        "evaluateExternal",
        help="score one or more methods' results on a real dataset "
        "against a per-read truth (evaluateExternalDatasets.pl)",
    )
    p_ee.add_argument("--DB", required=True)
    p_ee.add_argument("--truth", required=True,
                      help="per-read truth: readID<TAB>taxonID")
    p_ee.add_argument("--fastq", default=None)
    p_ee.add_argument("--method", action="append", required=True,
                      metavar="NAME=r2t[:dist]",
                      help="results files per method; repeatable")
    p_ee.add_argument("--output", required=True, help="output table prefix")
    p_ee.add_argument("--plots", action="store_true",
                      help="also produce the paperPlots figure set "
                      "(readsPanel/readAccuracy/abundanceXY/composition/"
                      "unknownFrequency PDFs)")
    p_ee.add_argument("--plotLevel", default="species")

    p_pl = sub.add_parser("plotIdentities", help="per-genome identity/coverage panels (PDF)")
    p_pl.add_argument("--mappings", required=True)
    p_pl.add_argument("--output", default=None)

    p_dl = sub.add_parser(
        "downloadRefSeq",
        help="download RefSeq genomes + taxonomy (or produce a manifest)",
    )
    p_dl.add_argument("--targetDir", required=True)
    p_dl.add_argument("--branches", default=None, help="comma-separated refseq branches")
    p_dl.add_argument("--fetch", action="store_true",
                      help="actually download (default: write a manifest only)")
    p_dl.add_argument("--taxonomyDir", default=None,
                      help="with --fetch: download + extract taxdump here")
    p_dl.add_argument("--skipIncompleteGenomes", action="store_true",
                      help="keep only 'Complete Genome' assemblies")
    p_dl.add_argument("--maxAssemblies", type=int, default=None)
    p_dl.add_argument("--baseUrl", default=None,
                      help="mirror root (default https://ftp.ncbi.nlm.nih.gov)")
    p_dl.add_argument("--DB", default="refseq", choices=["refseq", "genbank"])


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--engine", choices=ENGINES, default="torch",
                   help="mapping engine of the metamaps runs: the batched "
                   "torch engine on --device (default) or the serial host "
                   "engine (oracle); the outputs are identical")
    _add_device_arg(p, "torch engine and of the EM rounds")


def _run_tool(args, engine_stats: dict = None) -> int:
    """One database, simulation or analysis subcommand, as the JAX
    package's CLI runs it (``metamaps_tpu/cli.py:337-691``).
    ``engine_stats`` is ``run_experiment``'s ``run_stats`` for
    ``experiments``, and ``run_inference``'s ``stats`` for ``simulate
    --action inference``."""
    if args.command == "geneLevelAnalysis":
        from .tools.gene_level import gene_level_analysis

        out, n_with, n_without = gene_level_analysis(args.DB, args.mappings)
        print(f"{out} ({n_with} reads on annotated contigs, {n_without} without)")
        return 0

    if args.command == "filterWIMP":
        from .tools.wimp_filter import filter_low_identity

        out_wimp, out_r2t, removed = filter_low_identity(
            args.DB, args.mappings, args.identityThreshold
        )
        print(f"{out_wimp} ({len(removed)} mapping units removed)")
        return 0

    if args.command == "convertDB":
        from .tools import convert

        fn = {"kraken": convert.to_kraken, "centrifuge": convert.to_centrifuge,
              "mash": convert.to_mash}[args.to]
        print(fn(args.DB, args.output))
        return 0

    if args.command == "compareMappings":
        from .tools.compare import compare_mappings

        r = compare_mappings(args.fileA, args.fileB, args.posTolerance)
        print(
            f"reads: {r['n_a']} vs {r['n_b']}; identical {r['identical']}; "
            f"different {len(r['different'])}; only-A {len(r['only_a'])}; "
            f"only-B {len(r['only_b'])}"
        )
        return 0

    if args.command == "benchmarkInference":
        from .tools.compare import benchmark_inference

        print(benchmark_inference(args.mappings, args.truth))
        return 0

    if args.command == "plotIdentities":
        from .tools.plots import plot_identities_em

        print(plot_identities_em(args.mappings, args.output))
        return 0

    if args.command == "evaluateExternal":
        from .sim.external_eval import evaluate_external, parse_method_spec

        methods = dict(parse_method_spec(s) for s in args.method)
        result = evaluate_external(
            args.DB, args.truth, methods, fastq=args.fastq,
            out_prefix=args.output,
        )
        m = result["meta"]
        print(
            f"{m['n_truth_reads']} truth reads "
            f"({m['n_truth_taxa_changed_by_projection']} projected to "
            f"DB-mappable ancestors); wrote {args.output}.readLevel.tsv, "
            f"{args.output}.distribution.tsv"
        )
        if args.plots:
            from .sim.external_eval import read_lengths_from_fastx
            from .sim.validation import parse_wimp
            from .tools.paper_plots import paper_plot_suite

            dists = {
                name: parse_wimp(mf.distribution)
                for name, mf in methods.items() if mf.distribution
            }
            lens = (
                {"reads": list(read_lengths_from_fastx(args.fastq).values())}
                if args.fastq else None
            )
            for fn in paper_plot_suite(
                result, result["truth_distribution"], dists, args.output,
                read_lengths=lens, level=args.plotLevel,
            ):
                print(fn)
        return 0

    if args.command == "downloadRefSeq":
        from .db.download import NCBI_FTP, fetch, make_plan, write_manifest

        branches = args.branches.split(",") if args.branches else None
        plan = make_plan(args.targetDir, branches, section=args.DB,
                         base_url=args.baseUrl or NCBI_FTP)
        if args.fetch:
            levels = (
                ("Complete Genome",) if args.skipIncompleteGenomes
                else ("Complete Genome", "Chromosome")
            )
            res = fetch(
                plan, assembly_levels=levels,
                taxonomy_dir=args.taxonomyDir,
                max_assemblies=args.maxAssemblies, progress=True,
            )
            print(
                f"downloaded {res.assemblies_downloaded} assemblies "
                f"({res.assemblies_skipped} already local, "
                f"{len(res.failures)} failures -> {res.report_path})"
            )
            return 0 if not res.failures else 1
        print(write_manifest(plan, args.targetDir.rstrip("/") + ".manifest"))
        return 0

    if args.command == "synthDB":
        import numpy as np

        from .sim.synth_db import write_synth_db_dir

        taxa = write_synth_db_dir(
            args.out, np.random.default_rng(args.seed),
            n_genera=args.genera, species_per_genus=args.speciesPerGenus,
            genome_len=args.genomeLen,
            intra_genus_divergence=args.divergence,
        )
        print(f"synthDB: {len(taxa)} genomes "
              f"({args.genera} genera x {args.speciesPerGenus} species, "
              f"{args.genomeLen} bp each) -> {args.out}")
        return 0

    if args.command == "experiments":
        from .sim.experiments import (
            ExperimentSpec,
            pick_holdout_taxa,
            run_experiment,
        )

        variants = {"full": []}
        if args.holdout:
            if args.holdout.startswith("auto"):
                n = int(args.holdout[4:] or "2")
                taxa = pick_holdout_taxa(args.DB, n, args.seed)
            else:
                taxa = args.holdout.split(",")
            variants["holdout"] = taxa
        spec = ExperimentSpec(
            name=args.name, db_dir=args.DB, n_reads=args.nReads,
            seed=args.seed, mean_length=args.meanLength,
            accuracy=args.accuracy, min_read_len=args.minReadLen,
            variants=variants, tools=args.tools.split(","),
            engine=args.engine, device=args.device,
        )
        results = run_experiment(spec, args.store, run_stats=engine_stats)
        n_ok = sum(1 for r in results.values() if "skipped" not in r)
        print(f"experiments: {n_ok}/{len(results)} runs completed; "
              f"tables under {os.path.join(args.store, args.name, 'tables')}")
        return 0

    if args.command == "simulate":
        import numpy as np

        rng = np.random.default_rng(args.seed)
        if args.action == "reads":
            from .sim.simulate import simulate_reads, write_simulation

            reads = simulate_reads(args.DB, args.nReads, rng,
                                   mean_length=args.meanLength,
                                   accuracy=args.accuracy)
            write_simulation(reads, args.out)
            print(f"{len(reads)} reads -> {args.out}.fastq / {args.out}.truth")
        elif args.action == "reducedDB":
            from .sim.simulate import produce_reduced_db

            if not args.removeTaxa:
                print("Please specify --removeTaxa", file=sys.stderr)
                return 1
            produce_reduced_db(args.DB, args.out, args.removeTaxa.split(","))
            print(args.out)
        elif args.action == "inference":
            from .sim.simulate import run_inference

            if not args.reads:
                print("Please specify --reads", file=sys.stderr)
                return 1
            print(run_inference(args.DB, args.reads, args.out,
                                engine=args.engine, device=args.device,
                                stats=engine_stats))
        else:  # evaluate
            from .sim.validation import evaluate_experiment

            if not (args.truth and args.mappings):
                print("Please specify --truth and --mappings", file=sys.stderr)
                return 1
            result = evaluate_experiment(args.DB, args.truth, args.mappings)
            print(json.dumps(result, indent=1, default=str))
        return 0

    if args.command == "buildTruth":
        from .io.fasta import read_sequences
        from .sim.truth import (
            project_truth_into_db,
            read_accession_table,
            truth_from_read_headers,
            write_truth,
        )

        table = read_accession_table(args.accessions)
        rids = [name for name, _ in read_sequences(args.reads)]
        truth = truth_from_read_headers(rids, table, pattern=args.pattern)
        if args.DB:
            from .engine.em import load_relevant_taxon_info
            from .taxonomy import Taxonomy

            taxonomy = Taxonomy(os.path.join(args.DB, "taxonomy"))
            mappable = set(load_relevant_taxon_info(args.DB, set()))
            truth = project_truth_into_db(truth, taxonomy, mappable)
        write_truth(truth, args.output)
        n_hit = sum(1 for t in truth.values() if t != "0")
        print(f"{len(truth)} reads ({n_hit} resolved) -> {args.output}")
        return 0

    if args.command == "truthDataset":
        from .sim.truth import truth_from_cami, truth_from_hmp, truth_from_zymo
        from .taxonomy import Taxonomy

        tax = Taxonomy(os.path.join(args.DB, "taxonomy")) if args.DB else None
        all_ids = None
        if args.reads:
            from .io.fasta import read_sequences

            all_ids = {name for name, _ in read_sequences(args.reads)}
        if args.dataset == "cami":
            out = truth_from_cami(args.mapping, args.output, taxonomy=tax)
        elif args.dataset == "zymo":
            out = truth_from_zymo(args.reference, args.alignments,
                                  args.output, taxonomy=tax,
                                  all_read_ids=all_ids)
        else:
            out = truth_from_hmp(args.alignments, args.gi2taxon, args.output,
                                 taxonomy=tax, all_read_ids=all_ids)
        print(f"truth written: {out}")
        return 0

    if args.command == "extractReads":
        from .tools.reads_util import extract_reads, reads_for_taxon

        if args.ids:
            with open(args.ids) as f:
                ids = [l.strip() for l in f if l.strip()]
        elif args.r2t and args.DB and args.target is not None:
            from .taxonomy import Taxonomy

            taxonomy = Taxonomy(os.path.join(args.DB, "taxonomy"))
            ids = reads_for_taxon(args.r2t, taxonomy, args.target)
        else:
            print("Please specify --ids, or --r2t with --DB and --target",
                  file=sys.stderr)
            return 1
        n = extract_reads(args.reads, ids, args.output, mode=args.mode)
        print(f"{n} reads -> {args.output}")
        return 0

    if args.command == "firstQuartileScore":
        from .tools.reads_util import first_quartile_quality

        print(first_quartile_quality(args.fastq))
        return 0

    if args.command == "shortenContigIDs":
        from .tools.misc import shorten_contig_ids

        shorten_contig_ids(args.input, args.output, args.mapping)
        return 0

    if args.command == "splitEggNog":
        from .tools import eggnog

        if args.action == "split":
            kw = {"target_chars": args.targetChars} if args.targetChars else {}
            n = eggnog.split_fasta(args.input, args.output, **kw)
            print(f"Done. Produced {n} files.")
        elif args.action == "submit":
            kw = {"cmd_template": args.cmd} if args.cmd else {}
            scripts = eggnog.write_submit_scripts(args.output, **kw)
            print(f"{len(scripts)} job scripts written; execute them to annotate.")
        else:
            print(eggnog.collect(args.output))
        return 0

    if args.command == "addTaxonIDToFasta":
        from .tools.misc import add_taxon_id_to_fasta

        add_taxon_id_to_fasta(args.input, args.output, args.taxonID)
        return 0

    if args.command == "buildDB":
        from .db.build_db import build_db

        build_db(args.FASTAs.split(","), args.DB, args.taxonomy,
                 shuffle_contigs=args.shuffle,
                 gff_files=args.gff.split(",") if args.gff else None,
                 protein_fastas=args.proteins.split(",") if args.proteins else None)
        return 0

    if args.command == "annotate":
        from .db.annotate import annotate_genomes

        pairs = []
        for spec in args.genomes.split(","):
            path, _, taxon = spec.rpartition("=")
            pairs.append((path, taxon))
        annotate_genomes(pairs, args.output, args.taxonomy)
        return 0

    if args.command == "validateDB":
        from .db.validate import validate_db

        info = validate_db(args.DB)
        print("DB OK:", info)
        return 0

    if args.command == "DBinfo":
        from .db.validate import db_info

        print(db_info(args.DB))
        return 0

    # selfSimilarity
    from .db import self_similarity as ss

    out_dir = args.DB.rstrip("/") + "/selfSimilarity"
    kw = {}
    if args.simFrom is not None:
        kw["sim_from"] = args.simFrom
    if args.simTo is not None:
        kw["sim_to"] = args.simTo
    if args.simStep is not None:
        kw["sim_step"] = args.simStep
    if args.maxChunks is not None:
        kw["max_chunks"] = args.maxChunks
    if args.mode == "prepare":
        jobs = ss.prepare(args.DB, out_dir)
        print(f"{len(jobs)} jobs -> {out_dir}/jobs.json")
    elif args.mode == "prepareFromTemplate":
        if not args.templateDB:
            print("Please specify --templateDB", file=sys.stderr)
            return 1
        jobs, n_copy, n_re = ss.prepare_from_template(
            args.DB, out_dir, args.templateDB
        )
        print(
            f"{len(jobs)} jobs: {n_copy} copied from template, "
            f"{n_re} recomputed -> selfSimilarities.txt"
        )
    elif args.mode == "runJob":
        jobs = ss.load_jobs(out_dir)
        ss.run_job(args.DB, jobs[args.jobI], out_dir, args.jobI, **kw)
    elif args.mode == "collect":
        print(ss.collect(args.DB, out_dir))
    else:
        print(ss.estimate_self_similarity(args.DB, out_dir, **kw))
    return 0


def main(argv=None, engine_stats: dict = None) -> int:
    """Run one subcommand. ``engine_stats``, when given, accumulates the
    mapping engine's counters (reads, oracle fallbacks, L2 candidates, the
    seconds spent on the minimum-hits table; for mapAgainstIndex also each
    shard's load seconds); for ``experiments`` it gets where the time went
    (``sim.experiments.run_experiment``'s ``run_stats``)."""
    args = _parser().parse_args(argv)
    if args.command not in CORE_COMMANDS:
        return _run_tool(args, engine_stats)
    if args.command == "classify":
        if args.emBackend != "numpy":
            require_cuda(args.device)
        params = Parameters()
        params.db = args.DB
        params.mappings_for_classification = args.mappings
        params.minimum_reads_for_u = args.minreads
        params.threads = args.threads
        # comma-separated mappings lists, as in the reference
        # (mash_map.cpp:311-316)
        for mf in args.mappings.split(","):
            do_em(params, mf, em_backend=args.emBackend, device=args.device)
        return 0

    if args.command == "classifyU":
        from .engine.u import do_u

        params = Parameters()
        params.db = args.DB
        params.mappings_for_classification = args.mappings
        params.minimum_reads_for_u = args.minreads
        for mf in args.mappings.split(","):
            do_u(params, mf)
        return 0

    if args.command == "mapAgainstIndex":
        from .engine.mapwrap import map_against_index

        if args.mapping_engine == "torch":
            require_cuda(args.device)
        params = Parameters()
        _query_params(params, args)
        map_against_index(params, args.index, device=args.device,
                          engine_stats=engine_stats, profile=args.profile)
        return 0

    params = _sketch_params(args)
    if args.command == "index":
        from .engine.index import create_index

        params.index = args.index
        create_index(params, args.index, params.maximum_memory)
        return 0

    from .engine.mapwrap import map_directly

    if args.mapping_engine == "torch":
        require_cuda(args.device)
    _query_params(params, args)
    if args.mesh:
        from .parallel.sharded_engine import (
            map_directly_sharded,
            parse_mesh_spec,
        )

        if args.mapping_engine != "torch":
            print("metamaps_tpu_torch: --mesh maps with the torch engine",
                  file=sys.stderr)
            return 2
        n_shard, n_data = parse_mesh_spec(args.mesh)
        buckets = (
            tuple(int(x) for x in args.meshBuckets.split(","))
            if args.meshBuckets else None
        )
        map_directly_sharded(
            params, n_shard, n_data,
            read_len_buckets=buckets,
            rows_per_device=args.meshRows,
            progress=bool(args.meshProgress),
            devices=(None if args.device == "cuda"
                     else ["cpu"] * (n_shard * n_data)),
            engine_stats=engine_stats, profile=args.profile,
        )
        return 0
    map_directly(params, params.maximum_memory, device=args.device,
                 engine_stats=engine_stats, profile=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
