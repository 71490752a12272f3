"""reads_per_s: mappable reads of the files completed in the window over
the window's seconds (the window ends when its last file ends)."""


def read(ctx, st):
    recs = ctx.record.get("files")
    if not recs:
        return None
    return sum(r["reads"] for r in recs) / ctx.record["window_s"]
