"""Command-line interface of the port.

Counterpart: ``metamaps_tpu/cli.py``. The reference's five core
subcommands run through the port: ``index``, ``mapDirectly`` (single shard
or the memory-bounded shard loop), ``mapAgainstIndex`` (the stored shards
of an ``index``), ``classify`` (EM rounds in float64 on ``--device``) and
``classifyU`` (host code, as in the JAX package). Every other subcommand of
the JAX package's CLI prints "not ported yet" and returns 2.

    python -m metamaps_tpu_torch mapDirectly --reference DB/DB.fa \\
        --query reads.fastq --output out --all
    python -m metamaps_tpu_torch index --reference DB/DB.fa --index idx/DB
    python -m metamaps_tpu_torch mapAgainstIndex --index idx/DB \\
        --query reads.fastq --output out --all
    python -m metamaps_tpu_torch classify --DB DB --mappings out
    python -m metamaps_tpu_torch classifyU --DB DB --mappings out
"""
from __future__ import annotations

import argparse
import math
import sys

from .device import require_cuda
from .engine.em import EM_BACKENDS, do_em
from .engine.mapwrap import ENGINES
from .io.fasta import total_file_size
from .params import Parameters

NOT_PORTED = (
    "experiments", "synthDB", "simulate",
    "buildTruth", "truthDataset", "extractReads", "firstQuartileScore",
    "shortenContigIDs", "splitEggNog", "addTaxonIDToFasta", "buildDB",
    "annotate", "validateDB", "DBinfo", "selfSimilarity", "geneLevelAnalysis",
    "filterWIMP", "convertDB", "compareMappings", "benchmarkInference",
    "evaluateExternal", "plotIdentities", "downloadRefSeq",
)


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
                   "per shard and query file (a synchronise after each "
                   "phase)")


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
                             "--device (default), numpy = host float64 (parity path)")
            _add_device_arg(p_c, "EM rounds")
    return parser


def main(argv=None, engine_stats: dict = None) -> int:
    """Run one subcommand. ``engine_stats``, when given, accumulates the
    mapping engine's counters (reads, oracle fallbacks, L2 candidates, the
    seconds spent on the minimum-hits table; for mapAgainstIndex also each
    shard's load seconds)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"metamaps_tpu_torch: {argv[0]} is not ported yet",
              file=sys.stderr)
        return 2

    args = _parser().parse_args(argv)
    if args.command == "classify":
        if args.emBackend == "torch":
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
    map_directly(params, params.maximum_memory, device=args.device,
                 engine_stats=engine_stats, profile=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
