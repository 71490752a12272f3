"""engine.reads_per_chunk: reads per bucket chunk the engine maps (each
chunk's fixed cost of launches and fetches is shared by its reads): Σ
``reads`` over the count of the program's ``engine.chunk`` spans that
start in the window."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "engine.chunk")
    if spans is None:
        return None
    return sum(s.attrs["reads"] for s in spans) / len(spans)
