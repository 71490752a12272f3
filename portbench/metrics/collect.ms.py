"""collect.ms: the engine's collect phase, which holds its oracle
fallbacks, ms per 1000 reads."""
from portbench.layers import phase_ms


def read(ctx, st):
    return phase_ms(ctx, "collect")
