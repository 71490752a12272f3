"""sketch.ms: the engine's upload and sketch phases, ms per 1000 reads."""
from portbench.layers import phase_ms


def read(ctx, st):
    return phase_ms(ctx, "upload", "sketch")
