"""Command-line interface of the port.

Counterpart: ``metamaps_tpu/cli.py``. ``mapDirectly`` (single shard or the
memory-bounded shard loop) and ``index`` run through the port;
``classify``, ``classifyU`` and every other host-only subcommand are handed
to ``metamaps_tpu.cli.main`` unchanged (``classify`` runs the float64 host
EM there). ``mapAgainstIndex`` is not ported yet.

    python -m metamaps_tpu_torch mapDirectly --reference DB/DB.fa \\
        --query reads.fastq --output out --all
    python -m metamaps_tpu_torch classify --DB DB --mappings out
"""
from __future__ import annotations

import argparse
import sys

from metamaps_tpu.cli import _add_sketch_args, _sketch_params

from .engine.mapwrap import ENGINES

PORT_COMMANDS = ("index", "mapDirectly")
NOT_PORTED = ("mapAgainstIndex",)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="metamaps_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_idx = sub.add_parser("index", help="build index")
    _add_sketch_args(p_idx)
    p_idx.add_argument("--index", "-i", required=True, help="index output prefix")

    p_map = sub.add_parser("mapDirectly", help="map reads (index built on the fly)")
    _add_sketch_args(p_map)
    p_map.add_argument("--query", "-q", required=True,
                       help="reads FASTA/FASTQ (comma-separated list allowed)")
    p_map.add_argument("--output", "-o", required=True,
                       help="output prefix (comma-separated list allowed)")
    p_map.add_argument("--all", action="store_true",
                       help="report all mappings, not just the top band")
    p_map.add_argument("--threads", "-t", type=int, default=1,
                       help="host-side winnowing threads for the index build")
    p_map.add_argument("--mapping-engine", choices=ENGINES, default="torch",
                       help="batched torch engine (default) or serial host "
                       "engine (oracle)")
    p_map.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="device of the torch engine; it raises when CUDA "
                       "is absent unless cpu is given")
    return parser


def main(argv=None, engine_stats: dict = None) -> int:
    """Run one subcommand. ``engine_stats``, when given, accumulates the
    mapping engine's counters (reads, oracle fallbacks, L2 candidates)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"metamaps_tpu_torch: {argv[0]} is not ported yet; use "
              f"python -m metamaps_tpu.cli {argv[0]}", file=sys.stderr)
        return 2
    if not argv or argv[0] not in PORT_COMMANDS:
        from metamaps_tpu.cli import main as reference_main

        return reference_main(argv)

    args = _parser().parse_args(argv)
    params = _sketch_params(args)
    if args.command == "index":
        from .engine.index import create_index

        params.index = args.index
        create_index(params, args.index, params.maximum_memory)
        return 0

    from .engine.mapwrap import map_directly

    params.query_sequences = [args.query]
    params.out_file_name = args.output
    params.report_all = bool(args.all)
    params.threads = args.threads
    params.engine = args.mapping_engine
    map_directly(params, params.maximum_memory, device=args.device,
                 engine_stats=engine_stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
