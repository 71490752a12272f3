"""l2.ms: the engine's L2 phase (setup, sweep, finish), ms per 1000 reads."""
from portbench.layers import phase_ms


def read(ctx, st):
    return phase_ms(ctx, "l2")
