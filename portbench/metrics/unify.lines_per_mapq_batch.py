"""unify.lines_per_mapq_batch: mapping lines per batch of mapping qualities
(each batch's one binomial pmf call is shared by its lines): Σ ``lines``
over Σ ``mapq_batches`` of the program's ``unify`` spans that start in the
window. None where the spans carry no ``mapq_batches``, or no batch ran."""
from portbench import core


def read(ctx, st):
    parse = core.load_piece(ctx.root, "metrics", "mapfile.parse_ms")
    spans = parse.window_spans(ctx, "unify")
    if spans is None or any("mapq_batches" not in s.attrs for s in spans):
        return None
    batches = sum(s.attrs["mapq_batches"] for s in spans)
    if batches == 0:
        return None
    return sum(s.attrs["lines"] for s in spans) / batches
