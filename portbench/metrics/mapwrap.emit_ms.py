"""mapwrap.emit_ms: map_query_file_against_shard less the engine's phase
seconds in the call (FASTQ read, report filter, line format), ms per 1000
mappable reads."""
from portbench.layers import engine_s, per_kread


def read(ctx, st):
    if not ctx.trace:
        return None
    return per_kread(ctx, lambda r: r["t1"] - r["t0"] - engine_s(r))
