"""CEED BP3's configuration and its cell ``bp3q1-cg``, and the blocked
float32 solve ``grid3d-cg16``: the configuration's counts and least
bytes, the harness finding the cells' files and readers, whole runs of
both cells on the CPU at a tiny size, and the reader of the value-plane
counters on hand-made records."""

import json
import time
import types

import pytest
import torch

import harness
import program_trace
import roofline
from conftest import ROOT
from tpusparse_torch.utils import trace
from tpusparse_torch.utils.trace import Span

BP3, GRID = "bp3q1-cg", "grid3d-cg16"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CFG = json.loads(
    (ROOT / "benchmark/configs/ceed-bp3-q1-perturbed-160.json").read_text())
READER = "planes_read_ratio.solve"
SEED = 2**31 + 23


def _metrics_for(cell, trace_on):
    return {m["name"] for m in BENCH["per_layer" if trace_on
                                     else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def _planes_bytes(n):
    """A K5d product on 27 float64 planes at L = 1: the planes, x and y."""
    return 27 * n * 8 + 2 * n * 8


def test_counts_and_least_bytes_in_config():
    m = CFG["elements"] - 1
    assert CFG["num_rows"] == m ** 3 == 4_019_679
    assert CFG["nnz"] == (3 * m - 2) ** 3 == 107_171_875
    n, nnz = CFG["num_rows"], CFG["nnz"]
    least = roofline.least_bytes(CFG, n, nnz, 1)
    # the upper triangle with the diagonal in float64 (the one offset
    # more of a row count adds 4 B), x and y once
    assert least == (nnz + n) // 2 * 8 + 4 + 2 * n * 8
    assert _planes_bytes(n) / least == pytest.approx(1.8319, abs=1e-4)
    # bytes bound it: 509 MB / 3.35 TB/s against 214 MFLOP / 34 TFLOP/s
    assert roofline.least_ms(CFG, n, nnz, 1) == pytest.approx(
        least / 3.35e12 * 1e3)


def test_harness_finds_the_cells_files_and_readers():
    cell = harness.find_cell(ROOT, BP3, True)
    assert cell.cfg["generator"] == "bp3q1" and cell.dtype == torch.float64
    assert cell.kind == "solve" and int(cell.mix["lanes"]) == 1
    assert cell.limits == {"unconverged": 0, "true_resid": 1e-5,
                           "resid_gap": 1e-6}
    assert cell.matrix.__file__.endswith("matrices/bp3q1.py")
    assert set(cell.readers) == _metrics_for(BP3, True)
    assert READER in cell.readers
    assert set(harness.find_cell(ROOT, BP3, False).readers) == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    grid = harness.find_cell(ROOT, GRID, True)
    assert grid.cfg["generator"] == "grid3d7" and grid.dtype == torch.float32
    assert grid.kind == "solve" and int(grid.mix["lanes"]) == 16
    assert set(grid.limits) == {"unconverged", "true_resid", "resid_gap"}
    assert READER not in grid.readers
    assert set(harness.find_cell(ROOT, GRID, False).readers) == {
        "setup_s", "solve_ms.multi"}


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("cell", [BP3, GRID])
def test_cell_runs_correct_with_its_metrics(tiny_root, cell, trace_on):
    out = harness.run_cell(tiny_root, cell, SEED, 0.2, trace_on, "cpu",
                           time.perf_counter(), {"import": 0.0})
    trace.disable()
    trace.take()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = _metrics_for(cell, trace_on)
    device_only = {m for m in want if m.split(".")[0] in (
        "launches_per_iter", "blas1_ms_per_iter", "product_roofline",
        "device_idle_pct")}
    assert want - device_only == set(out["metrics"])
    if trace_on and cell == BP3:
        # the tiny mesh: (E - 1)^3 rows, (3 (E - 1) - 2)^3 nonzeros
        cfg = json.loads(
            (tiny_root / "benchmark/configs/ceed-bp3-q1-perturbed-160.json")
            .read_text())
        m = cfg["elements"] - 1
        n, nnz = m ** 3, (3 * m - 2) ** 3
        assert out["metrics"][READER]["value"] == pytest.approx(
            _planes_bytes(n) / roofline.least_bytes(cfg, n, nnz, 1))


@pytest.fixture
def reader():
    """The reader, loaded as the harness loads it (which arms the
    program's tracer); the tracer off and empty afterwards."""
    try:
        yield harness.load_module(ROOT / "benchmark/metrics" / f"{READER}.py")
    finally:
        trace.disable()
        trace.take()


US = 1000  # ns


def _record(monkeypatch, counted):
    """Two window solves, then a profiled one; ``counted`` maps a window
    solve's index to its (calls, bytes)."""
    spans, counters = [], {}
    for k in range(2):
        sid = 10 + k
        t = 10 * k * US
        spans.append(Span("cg.solve", sid, None, sid, t, t + 5 * US, False))
        if k in counted:
            calls, nbytes = counted[k]
            counters.setdefault("dia.planes_calls", {})[sid] = calls
            counters.setdefault("dia.planes_bytes", {})[sid] = nbytes
    spans.append(Span("cg.solve", 30, None, 30, 50 * US, 55 * US, True))
    counters.setdefault("dia.planes_calls", {})[30] = 1000
    counters.setdefault("dia.planes_bytes", {})[30] = 1
    monkeypatch.setattr(program_trace, "_record", (spans, counters))


def _run(kind="solve"):
    return types.SimpleNamespace(
        kind=kind, window=types.SimpleNamespace(ops=2), cell=types.
        SimpleNamespace(cfg=CFG), num_rows=CFG["num_rows"], nnz=CFG["nnz"],
        lanes=1)


def test_reader_reads_the_window_solves(reader, monkeypatch):
    n = CFG["num_rows"]
    least = roofline.least_bytes(CFG, n, CFG["nnz"], 1)
    _record(monkeypatch, {0: (171, 171 * _planes_bytes(n)),
                          1: (160, 160 * _planes_bytes(n))})
    assert reader.read(_run()) == pytest.approx(_planes_bytes(n) / least)
    _record(monkeypatch, {})                  # a program without them
    assert reader.read(_run()) is None
    monkeypatch.setattr(program_trace, "_record", None)
    monkeypatch.setattr(program_trace, "_trace", None)
    assert reader.read(_run()) is None        # a program without a tracer
    assert reader.read(_run("product")) is None
