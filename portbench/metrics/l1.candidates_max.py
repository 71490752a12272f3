"""l1.candidates_max: the most L1 candidate regions one read had in the
window (set against the engine's ``cands_max``, above which a read goes to
the serial oracle): the largest ``cands_max_read`` of the program's
``engine.chunk`` spans that start in the window. None where the spans
carry no ``cands_max_read``."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "engine.chunk")
    if spans is None or any("cands_max_read" not in s.attrs for s in spans):
        return None
    return max(s.attrs["cands_max_read"] for s in spans)
