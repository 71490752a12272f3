"""Spans of the program's host time, kept in memory.

``span(name, **attrs)`` times a block on ``time.perf_counter_ns`` (the
clock of ``time.perf_counter``) and, when the block ends, records its name,
start, end, id, its parent's id (0 for none) and its root's id, and the
attributes set on it, in a ring of the last :data:`RING` spans.
:func:`spans` returns them, oldest first. Spans nest per thread.

Spans are always recorded, so a run that reads them and one that does not
run the same host code. They are kept at batch, chunk and phase
granularity, never one a read: per-read time is summed into an attribute
of the enclosing span.

While a ``torch.profiler`` is active, and only then, each span also opens
``torch.profiler.record_function("metamaps." + name)``, which puts it on
the profiler's trace, nested inside whatever the caller annotated.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple

import torch

#: spans the ring keeps: ~50 a mapped and unified file, so a few thousand
#: files
RING = 1 << 17
PROFILER_PREFIX = "metamaps."


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int  # 0 for a root span
    root: int
    t0_ns: int
    t1_ns: int
    attrs: dict


_lock = threading.Lock()
_ring: List[SpanRecord] = [None] * RING
_count = 0  # spans recorded since import
_ids = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # the thread's open spans, outermost first


_local = _Local()


class Span:
    """An open span; set attributes inside the block with :meth:`set`."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "t0_ns", "t1_ns",
                 "_annot")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _local.stack
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self._annot = None
        if torch._C._autograd._profiler_enabled():
            self._annot = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self._annot.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        _local.stack.pop()
        _record(SpanRecord(self.name, self.id, self.parent, self.root,
                           self.t0_ns, self.t1_ns, self.attrs))
        return False


def span(name: str, **attrs) -> Span:
    """A context manager that records a span called ``name``."""
    return Span(name, attrs)


def _record(rec: SpanRecord) -> None:
    global _count
    with _lock:
        _ring[_count % RING] = rec
        _count += 1


def spans() -> List[SpanRecord]:
    """A snapshot of the ring's spans in the order they ended."""
    with _lock:
        if _count <= RING:
            return _ring[:_count]
        i = _count % RING
        return _ring[i:] + _ring[:i]


def reaches(t_ns: int) -> bool:
    """Whether the ring still holds every span that started at or after
    ``t_ns``: nothing has been dropped, or the oldest span kept ended by
    then (spans are dropped in the order they ended)."""
    with _lock:
        return _count <= RING or _ring[_count % RING].t1_ns <= t_ns
