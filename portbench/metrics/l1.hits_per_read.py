"""l1.hits_per_read: index occurrences of the reads' minimizers under the
frequency threshold (the L1 hits the engine expands) per read it mapped:
Σ ``hits`` over Σ ``reads`` of the program's ``engine.chunk`` spans that
start in the window. None where the spans carry no ``hits``."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "engine.chunk")
    if spans is None or any("hits" not in s.attrs for s in spans):
        return None
    return (sum(s.attrs["hits"] for s in spans)
            / sum(s.attrs["reads"] for s in spans))
