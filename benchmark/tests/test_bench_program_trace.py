"""The readers of the program's own spans and counters
(``program_trace.py`` and the metrics that read it), on hand-made
records, and the device trace charging an idle gap to a program span."""

import types

import pytest

import devtrace
import harness
import program_trace
from conftest import ROOT
from tpusparse_torch.utils import trace
from tpusparse_torch.utils.trace import Span

NEW = ["plan_select_s", "plan_partition_s", "plan_operand_s", "plan_passes",
       "host_us_per_iter", "host_us_per_iter.multi", "test_us_per_iter",
       "test_us_per_iter.multi", "dispatch_self_us.product"]
US = 1000  # ns


@pytest.fixture
def readers():
    """Every new reader, loaded as the harness loads them (which arms the
    program's tracer); the tracer off and empty afterwards."""
    try:
        yield {n: harness.load_module(ROOT / "benchmark/metrics" / f"{n}.py")
               for n in NEW}
    finally:
        trace.disable()
        trace.take()


def _given(monkeypatch, spans, counters=None):
    monkeypatch.setattr(program_trace, "_record", (spans, counters or {}))


def _run(kind, nnz=1000, window_ops=0):
    return types.SimpleNamespace(
        kind=kind, nnz=nnz, window=types.SimpleNamespace(ops=window_ops))


def _plan(root, t0, select, partition, operand):
    """A plan_matrix request from t0 (ns): its phases of the given
    microseconds, back to back, the operand with an upload inside."""
    out, t = [], t0 + 1
    for k, (name, us) in enumerate((("plan.select", select),
                                    ("plan.partition", partition),
                                    ("plan.operand", operand))):
        if us is None:
            continue
        out.append(Span(name, root + 1 + k, root, root, t, t + us * US,
                        False))
        t += us * US
    op = out[-1]
    out.insert(-1, Span("plan.upload", root + 9, op.id, root, op.start_ns,
                        op.start_ns + US, False))
    out.append(Span("plan_matrix", root, None, root, t0, t + 1, False))
    return out


def test_plan_readers_read_the_cells_own_plan(readers, monkeypatch):
    # the 2 x 2 plan that loads the library, then the cell's
    spans = _plan(1, 0, 5, 6, 7) + _plan(100, 10**6, 3000, 2000, 4000)
    counters = {"plan.nnz_scanned": {1: 6, 100: 3000, None: 17}}
    _given(monkeypatch, spans, counters)
    run = _run("solve")
    assert readers["plan_select_s"].read(run) == pytest.approx(3e-3)
    assert readers["plan_partition_s"].read(run) == pytest.approx(2e-3)
    assert readers["plan_operand_s"].read(run) == pytest.approx(4e-3)
    assert readers["plan_passes"].read(run) == 3.0


def test_a_merge_plan_has_no_partition(readers, monkeypatch):
    _given(monkeypatch, _plan(7, 0, 3000, None, 4000),
           {"plan.nnz_scanned": {7: 1000}})
    run = _run("product")
    assert readers["plan_partition_s"].read(run) is None
    assert readers["plan_operand_s"].read(run) == pytest.approx(4e-3)
    assert readers["plan_passes"].read(run) == 1.0


def _solve(root, t0, iters, it_us, test_us, profiled):
    """A cg.solve request of ``iters`` iterations: a test before each
    and one more that ends the loop."""
    out, t, k = [], t0 + 1, root + 1
    for i in range(iters + 1):
        out.append(Span("cg.test", k, root, root, t, t + test_us * US,
                        profiled))
        t, k = t + test_us * US, k + 1
        if i == iters:
            break
        out.append(Span("spmv", k + 1, k, root, t + 1, t + 2, profiled))
        out.append(Span("cg.iteration", k, root, root, t, t + it_us * US,
                        profiled))
        t, k = t + it_us * US, k + 2
    out.append(Span("cg.solve", root, None, root, t0, t + 1, profiled))
    return out


def test_solver_readers_read_the_window_solves(readers, monkeypatch):
    # the warm-up's solve, the window's two, then a profiled one
    spans = (_solve(1, 0, 4, 900, 900, False)
             + _solve(100, 10**8, 2, 300, 500, False)
             + _solve(200, 2 * 10**8, 3, 300, 500, False)
             + _solve(300, 3 * 10**8, 5, 900, 900, True))
    _given(monkeypatch, spans)
    run = _run("solve", window_ops=2)
    for name in ("host_us_per_iter", "host_us_per_iter.multi"):
        assert readers[name].read(run) == pytest.approx(300.0)
    # 3 + 4 tests of 500 us over 5 iterations
    for name in ("test_us_per_iter", "test_us_per_iter.multi"):
        assert readers[name].read(run) == pytest.approx(700.0)
    assert readers["host_us_per_iter"].read(_run("solve")) is None
    assert readers["host_us_per_iter"].read(_run("product")) is None
    assert readers["dispatch_self_us.product"].read(run) is None


def _call(root, t0, total, kernels, profiled, nested=False):
    """An spmv request from t0 (ns) of ``total`` us, a kernel span of
    each of ``kernels`` us below it, under a nested spmv (a hybrid's
    part) where ``nested``."""
    out, t, up = [], t0 + US, root
    if nested:
        up = root + 50
        out.append(Span("spmv", up, root, root, t0 + 1,
                        t0 + total * US - 1, profiled))
    for k, us in enumerate(kernels):
        out.insert(0, Span("kernel.K2", root + 1 + k, up, root, t,
                           t + us * US, profiled))
        t += us * US
    out.append(Span("spmv", root, None, root, t0, t0 + total * US,
                    profiled))
    return out


def test_dispatch_self_time_reads_the_bursts(readers, monkeypatch):
    # a warm-up call, two profiled calls, then three calls of the
    # bursts, one of them a hybrid's with its kernels a level down
    spans = (_call(100, 0, 500, [100], False)
             + _call(200, 10**7, 300, [30], True)
             + _call(300, 2 * 10**7, 300, [20], True)
             + _call(400, 3 * 10**7, 80, [60], False)
             + _call(500, 4 * 10**7, 90, [30, 40], False, nested=True)
             + _call(600, 5 * 10**7, 70, [50], False))
    _given(monkeypatch, spans)
    # (80 - 60 + 90 - 70 + 70 - 50) / 3
    assert readers["dispatch_self_us.product"].read(
        _run("product")) == pytest.approx(20.0)
    # no profiled segment: no burst to tell apart
    _given(monkeypatch, [s._replace(profiled=False) for s in spans])
    assert readers["dispatch_self_us.product"].read(_run("product")) is None
    _given(monkeypatch, [])
    assert readers["dispatch_self_us.product"].read(_run("product")) is None


def test_without_the_tracer_every_reader_gives_none(readers, monkeypatch):
    monkeypatch.setattr(program_trace, "_trace", None)
    monkeypatch.setattr(program_trace, "_record", None)
    for name, reader in readers.items():
        for kind in ("solve", "product"):
            assert reader.read(_run(kind)) is None, name


def test_loading_a_reader_arms_the_tracer_until_the_first_read(readers):
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.ops.spmv import plan_matrix

    plan_matrix(gen.make_laplacian_grid2d(6).to_csr(), device="cpu")
    spans, counters = program_trace.record()
    assert [s.name for s in spans if s.parent is None] == ["plan_matrix"]
    assert program_trace.record() == (spans, counters)   # taken once
    with trace.span("after"):
        pass
    assert trace.take() == ([], {})                     # and off
    program_trace.arm()                                 # a new run
    assert program_trace._record is None


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_an_idle_gap_inside_a_program_span_is_charged_to_it():
    """A span's profiler record is a ``cpu_op`` of the launching thread:
    a gap in device work while the host runs the span's own Python (no
    aten op below it) is the span's; one under an aten op inside it is
    the op's."""
    t = devtrace.parse({"traceEvents": [
        _ev(devtrace.WINDOW, "user_annotation", 0, 100),
        _ev("cg.iteration", "cpu_op", 5, 90),
        _ev("kernel.K1d", "cpu_op", 10, 10),
        _ev("aten::empty", "cpu_op", 11, 2),
        _ev("aten::mul", "cpu_op", 60, 20),
        _ev("k", "kernel", 0, 5, tid=7),
        _ev("k", "kernel", 20, 10, tid=7),
        _ev("k", "kernel", 50, 5, tid=7),
        _ev("k", "kernel", 75, 25, tid=7),
    ]})
    # gaps [5, 20] (mid 12.5: aten::empty), [30, 50] (mid 40: the
    # iteration's own Python), [55, 75] (mid 65: aten::mul)
    gaps = dict(t.idle_gaps)
    assert gaps == {"aten::empty": pytest.approx(15e-6),
                    "cg.iteration": pytest.approx(20e-6),
                    "aten::mul": pytest.approx(20e-6)}
