"""peak_device_gib: torch.cuda.max_memory_allocated over the whole run,
set-up included, in GiB (the card only)."""


def read(ctx, st):
    if not ctx.on_card:
        return None
    return ctx.record["peak_bytes"] / 2**30
