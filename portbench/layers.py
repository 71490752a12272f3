"""Arithmetic the metric readers share: per-layer sums over the timed
files' records, per 1000 mappable reads."""
from __future__ import annotations


#: engine phases timed inside another (the oracle fallbacks inside collect)
NESTED_PHASES = ("oracle",)


def engine_s(rec) -> float:
    """The engine's seconds in one file's mapping call."""
    return sum(v for k, v in rec["phase_s"].items() if k not in NESTED_PHASES)


def files(ctx):
    """The window's file records, or None (no mapping in this cell)."""
    return ctx.record.get("files") or None


def per_kread(ctx, seconds_of) -> float:
    """Milliseconds of ``seconds_of(record)`` per 1000 mappable reads."""
    recs = files(ctx)
    if recs is None:
        return None
    reads = sum(r["reads"] for r in recs)
    return 1e6 * sum(seconds_of(r) for r in recs) / reads


def phase_ms(ctx, *keys) -> float:
    """The engine's ``phase_s`` of ``keys`` per 1000 mappable reads; only
    in the traced run, whose engine synchronises after each phase."""
    if not ctx.trace:
        return None
    return per_kread(ctx, lambda r: sum(r["phase_s"].get(k, 0.0) for k in keys))


def idle_pct(ctx) -> float:
    """The device's idle share of the traced window, where a trace of the
    card was read."""
    tr = ctx.record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
