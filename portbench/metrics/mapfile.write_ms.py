"""mapfile.write_ms: the program's ``mapfile.write`` spans (report filter,
line format and write of each batch the engine mapped) that start in the
window, ms per 1000 mappable reads."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "mapfile.write")
    if spans is None:
        return None
    return parse.ms_per_kread(ctx, spans, lambda s: (s.t1_ns - s.t0_ns) * 1e-9)
