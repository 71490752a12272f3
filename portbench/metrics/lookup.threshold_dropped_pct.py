"""lookup.threshold_dropped_pct: share of the index occurrences of the
reads' minimizers that the frequency threshold removed: Σ
``hits_over_threshold`` over Σ (``hits`` + ``hits_over_threshold``) of the
program's ``engine.chunk`` spans that start in the window. None where the
spans carry no such counters, or no minimizer was found."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "engine.chunk")
    if spans is None or any("hits_over_threshold" not in s.attrs
                            for s in spans):
        return None
    over = sum(s.attrs["hits_over_threshold"] for s in spans)
    found = over + sum(s.attrs["hits"] for s in spans)
    return 100.0 * over / found if found else None
