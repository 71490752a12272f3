"""l1.ms: the engine's L1 regions and minimum-hits phases, ms per 1000
reads."""
from portbench.layers import phase_ms


def read(ctx, st):
    return phase_ms(ctx, "l1", "minhits")
