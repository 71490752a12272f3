"""sketch.kernel_chunk_pct: the share of the engine's chunks that the
program's hand-written sketch kernel sketched: 100 x the program's
``engine.chunk`` spans that start in the window with ``sketch_kernel`` 1,
over all of them. None where the spans carry no ``sketch_kernel``."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "engine.chunk")
    if spans is None or any("sketch_kernel" not in s.attrs for s in spans):
        return None
    return 100.0 * sum(s.attrs["sketch_kernel"] for s in spans) / len(spans)
