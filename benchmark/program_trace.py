"""The program's own spans and counters in a traced run: what
``tpusparse_torch.utils.trace`` records, for the readers of the
``program_span`` and ``program_counter`` metrics.

The harness loads a cell's per-layer readers, and only in a traced run,
before set-up. Each reader of the program's record calls ``arm()`` when
it is loaded: that drops what an earlier run of the process left and
switches the program's tracer on, from before set-up to the first
``record()``, which takes what the tracer holds and switches it off.
So the record holds set-up (the plan), the measured window, the
profiled segment (the spans that stand in the device trace,
``profiled``) and, for products, the dispatch bursts. The times are
read from the spans the profiler did not see (the window's solves, the
bursts' calls), since under the profiler each op on the host costs
several times more; the profiled spans serve only to name the device's
idle gaps. A program without the tracer (a commit older than it)
records nothing: ``record()`` gives None, and so does every reader.
"""

from __future__ import annotations

try:
    from tpusparse_torch.utils import trace as _trace
except ImportError:
    _trace = None

_record = None   # (spans, counters) taken in this run


def arm() -> None:
    """Switch the program's tracer on for this run, with nothing in it."""
    global _record
    if _trace is None:
        return
    _record = None
    _trace.take()
    _trace.enable()


def record():
    """(spans, counters) of this run, or None without the tracer."""
    global _record
    if _record is None and _trace is not None:
        _record = _trace.take()
        _trace.disable()
    return _record


def plan_request(spans):
    """The id of the cell's own ``plan_matrix`` call: the last one of
    set-up, which plans a 2 x 2 matrix first to load the library."""
    plans = [s for s in spans if s.name == "plan_matrix" and s.parent is None]
    return max(plans, key=lambda s: s.start_ns).id if plans else None


def plan_seconds(name: str):
    """Seconds of the ``name`` spans in the cell's plan, or None where
    the plan opened none."""
    rec = record()
    if rec is None:
        return None
    spans, _ = rec
    root = plan_request(spans)
    part = [s.seconds for s in spans if s.root == root and s.name == name]
    return sum(part) if part else None


def _profiled_from(spans):
    """Start of the first span the profiler saw (None: it saw none)."""
    return min((s.start_ns for s in spans if s.profiled), default=None)


def window_requests(spans, name: str, ops: int) -> set:
    """Ids of the measured window's ``ops`` requests named ``name``: the
    last ``ops`` roots of that name the profiler did not see that
    started before the profiled segment (the warm-up's come before)."""
    t = _profiled_from(spans)
    roots = sorted((s for s in spans if s.name == name and s.parent is None
                    and not s.profiled and (t is None or s.start_ns < t)),
                   key=lambda s: s.start_ns)
    return {s.id for s in roots[-ops:]} if ops > 0 else set()


def burst_requests(spans, names) -> dict:
    """The dispatch bursts' calls, id -> span: the roots named in
    ``names`` that started after the last profiled span ended."""
    ends = [s.end_ns for s in spans if s.profiled]
    if not ends:
        return {}
    t = max(ends)
    return {s.id: s for s in spans if s.name in names and s.parent is None
            and s.start_ns > t}


def per_iteration_us(run, name: str):
    """Microseconds of the ``name`` spans of the measured window's
    solves over their iterations, or None without a recorded
    iteration."""
    rec = record()
    if rec is None:
        return None
    spans, _ = rec
    solves = window_requests(spans, "cg.solve", run.window.ops)
    iters = sum(1 for s in spans
                if s.root in solves and s.name == "cg.iteration")
    if not iters:
        return None
    return sum(s.seconds for s in spans
               if s.root in solves and s.name == name) * 1e6 / iters
