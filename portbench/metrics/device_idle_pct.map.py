"""device_idle_pct.map: share of the traced window of the mapping cells in
which no operation ran on the card."""
from portbench.layers import idle_pct


def read(ctx, st):
    return idle_pct(ctx)
