"""A later change adds a configuration, a traffic mix, a cell and a
metric as new files only, and the harness finds them by name."""

import json
import time

import harness


def test_new_files_only_are_discovered(tiny_root):
    b = tiny_root / "benchmark"
    cfg = json.loads((b / "configs/hpcg-27pt-208.json").read_text())
    cfg.update(nx=5, ny=5, nz=5)
    (b / "configs/hpcg-27pt-5.json").write_text(json.dumps(cfg))
    mix = {"entry": "spmm", "lanes": 3, "check_samples": 2, "trace_ops": 2}
    (b / "traffic/spmm_l3.json").write_text(json.dumps(mix))
    (b / "workloads/hpcg5-spmm3.json").write_text(
        json.dumps({"limits": {"rel_err": 1e-6}}))
    (b / "metrics/lanes_seen.py").write_text(
        "def read(run):\n    return float(run.lanes)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "hpcg-27pt-5", "source": "test",
        "file": "benchmark/configs/hpcg-27pt-5.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({
        "name": "hpcg5-spmm3", "config": "hpcg-27pt-5",
        "traffic": "spmm_l3", "chips": 1, "why": "test"})
    bench["end_to_end"].append({
        "name": "lanes_seen", "unit": "lanes", "better": "higher",
        "bound": 0.01, "source": "host_clock", "workloads": ["hpcg5-spmm3"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = harness.run_cell(tiny_root, "hpcg5-spmm3", 9, 0.1, False, "cpu",
                           time.perf_counter(), {"import": 0.0})
    assert out["correct"], out["checks"]
    assert out["metrics"]["lanes_seen"] == {"value": 3.0, "unit": "lanes"}
    assert "product_gflops" not in out["metrics"]  # listed for other cells
    assert "setup_s" in out["metrics"]
