"""lookup.ms: the engine's lookup phase, ms per 1000 reads."""
from portbench.layers import phase_ms


def read(ctx, st):
    return phase_ms(ctx, "lookup")
