"""l2.candidates_per_read: candidates handed to L2 per mappable read
(the engine's l2_candidates counter)."""
from portbench.layers import files


def read(ctx, st):
    recs = files(ctx)
    if recs is None:
        return None
    return sum(r["l2_candidates"] for r in recs) / sum(r["reads"] for r in recs)
