"""file_p95_s: the 95th percentile over the files completed in the window
of the time from a file's start to its unified, mapQ-annotated output."""
import numpy as np


def read(ctx, st):
    recs = ctx.record.get("files")
    if not recs:
        return None
    return float(np.quantile([r["t2"] - r["t0"] for r in recs], 0.95))
