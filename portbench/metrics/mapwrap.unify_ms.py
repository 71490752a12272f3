"""mapwrap.unify_ms: unify_query_file (merge, mapping qualities, sidecars),
ms per 1000 mappable reads."""
from portbench.layers import per_kread


def read(ctx, st):
    return per_kread(ctx, lambda r: r["t2"] - r["t1"])
