"""Spans and counters at the port's layer boundaries, kept in memory.

The tracer is off until ``enable()`` is called. Off, ``span(name)``
returns one shared no-op context and ``count`` returns at once: one
test of a module-level flag each. On, each span records its name, its
own id, its parent's id, the id of its root span (the request it
belongs to: ``plan_matrix``, ``cg.solve``, ``spmv``, ``spmm``) and its
start and end on ``time.perf_counter_ns``; the parent is the innermost
span open, from one stack, since the port drives the card from one
thread. ``take()`` returns what was recorded and clears it.

While ``torch.profiler`` runs, each span also opens a profiler record
(``torch._C._profiler._RecordFunctionFast``) of the same name: the span
then stands in the profiler's own timeline, on the clock of the
kernels, as a host event of the launching thread, and the span's
``profiled`` field is true.

A counter adds whole numbers under its name and under the root span
open at the time (None outside any span), so that one request's count
can be read apart from another's.
"""

from __future__ import annotations

import itertools
import time
import typing

import torch
from torch._C._profiler import _RecordFunctionFast


class Span(typing.NamedTuple):
    name: str
    id: int
    parent: int | None       # None for a root span
    root: int                # the root span's id: the request
    start_ns: int            # time.perf_counter_ns
    end_ns: int
    profiled: bool           # a profiler record was open with it

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_on = False
_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)
_stack: list = []            # open _Span objects, innermost last
_spans: list = []            # closed spans, as the fields of a Span
_counters: dict = {}         # name -> {root id or None: total}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "record", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        up = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.record = None
        if _profiling():
            self.record = _RecordFunctionFast(self.name)
            self.record.__enter__()
        _stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        if self.record is not None:
            self.record.__exit__(None, None, None)
        _stack.pop()
        _spans.append((self.name, self.id, self.parent, self.root,
                       self.start, end, self.record is not None))
        return False


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``take()``."""
    global _on
    _on = False


def span(name: str):
    """A context manager that records one span named ``name``."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under the root span open now."""
    if not _on:
        return
    root = _stack[-1].root if _stack else None
    per_root = _counters.setdefault(name, {})
    per_root[root] = per_root.get(root, 0) + int(n)


def take() -> tuple[list, dict]:
    """(spans, counters) recorded since the last call, which are
    cleared: the spans in the order they closed, the counters as
    ``{name: {root id or None: total}}``."""
    global _spans, _counters
    out = ([Span._make(s) for s in _spans], _counters)
    _spans, _counters = [], {}
    return out
