"""Runs of every cell through the program's plain (CPU) versions, and
the shape of the result's last line."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import harness
import run as run_py
from conftest import ROOT, cell_names

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 977  # above 32 signed bits, as the driver's are


def _run(root, cell, trace, seed=SEED):
    t0 = time.perf_counter()
    return harness.run_cell(root, cell, seed, 0.2, trace, "cpu", t0,
                            {"import": 0.0})


def _metrics_for(cell, trace):
    return {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cell_names())
def test_cell_runs_correct_with_its_metrics(tiny_root, cell, trace):
    out = _run(tiny_root, cell, trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = _metrics_for(cell, trace)
    # device metrics need a card; the rest are read on the CPU too
    device_only = {m for m in want if m.split(".")[0] in (
        "launches_per_iter", "blas1_ms_per_iter", "product_roofline",
        "device_idle_pct")}
    assert want - device_only <= set(out["metrics"]) <= want
    for m in out["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(tiny_root, trace):
    out = _run(tiny_root, "rmat25-spmv", trace)
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "power_limit_w": 700.0}
    line = run_py.result_line(out, dev)
    text = json.dumps(line)
    assert "\n" not in text and json.loads(text) == line
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    else:
        assert "breakdown" not in line


def test_same_seed_same_inputs(tiny_root):
    a = _run(tiny_root, "hpcg27-cg", False)
    b = _run(tiny_root, "hpcg27-cg", False)
    assert a["checks"]["true_resid"] == b["checks"]["true_resid"]


def _cli(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hpcg27-cg",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    """Without a CUDA device the run prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _cli(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == "", p.stderr


def test_benchmark_alone_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and benchmark/, the run
    cannot import the program: no result, a failing exit code."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr
