"""mapfile.parse_ms: the program's ``mapfile.parse`` spans (FASTQ reading
and length filtering, each up to a batch handed to the engine) that start
in the window, ms per 1000 mappable reads. Also holds the window's span
lookup that the readers of the program's spans share."""
from portbench.layers import files


def window_spans(ctx, name):
    """The program's spans called ``name`` that start in the window
    ``[files[0]["t0"], files[-1]["t2"]]``, or None where the program
    records no spans (``metamaps_tpu_torch.trace``), none of them, or its
    ring no longer reaches the window's first file."""
    recs = files(ctx)
    if recs is None:
        return None
    try:
        from metamaps_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    w0, w1 = round(recs[0]["t0"] * 1e9), round(recs[-1]["t2"] * 1e9)
    if not trace.reaches(w0):
        return None
    got = [s for s in trace.spans() if s.name == name and w0 <= s.t0_ns <= w1]
    return got or None


def ms_per_kread(ctx, spans, seconds_of) -> float:
    """Milliseconds of ``seconds_of(span)`` summed over ``spans``, per 1000
    mappable reads of the window."""
    return 1e6 * sum(seconds_of(s) for s in spans) / sum(
        r["reads"] for r in files(ctx))


def read(ctx, st):
    spans = window_spans(ctx, "mapfile.parse")
    if spans is None:
        return None
    return ms_per_kread(ctx, spans, lambda s: (s.t1_ns - s.t0_ns) * 1e-9)
