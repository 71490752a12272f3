"""unify.mapq_ms: the seconds inside add_mapping_qualities, summed over the
program's ``unify`` spans that start in the window (their ``mapq_s``), ms
per 1000 mappable reads."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "unify")
    if spans is None:
        return None
    return parse.ms_per_kread(ctx, spans, lambda s: s.attrs["mapq_s"])
