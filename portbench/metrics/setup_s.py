"""setup_s: process start to the first timed call: data synthesis, the
index build and upload, warm-up (and the kernels' build on a first run)."""


def read(ctx, st):
    return ctx.record["setup_s"]
