"""index.build_s: the set-up span of the index build and table upload
(threaded winnow_fast, SketchShard.finalize, device_tables)."""


def read(ctx, st):
    return ctx.span_s("index.build") if ctx.trace else None
