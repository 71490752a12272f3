"""collect.oracle_fallback_pct: share of mappable reads the engine sent to
the serial oracle (its oracle_fallbacks counter)."""
from portbench.layers import files


def read(ctx, st):
    recs = files(ctx)
    if recs is None:
        return None
    return 100.0 * (sum(r["oracle_fallbacks"] for r in recs)
                    / sum(r["reads"] for r in recs))
