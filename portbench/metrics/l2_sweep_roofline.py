"""l2_sweep_roofline: the L2 sweep kernels' share of their roofline on the
traced files: the frozen sweep_bound summed over the slabs the engine
builds for those reads, over the kernels' device time (from the trace, or
CUDA events over a replay of the same slabs)."""


def read(ctx, st):
    sw = ctx.record.get("sweep")
    if not sw or sw["kernel_ms"] <= 0 or sw["slabs"] == 0:
        return None
    return 100.0 * sw["bound_ms"] / sw["kernel_ms"]
