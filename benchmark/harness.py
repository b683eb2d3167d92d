"""One run of one cell, found by name.

Everything that belongs to one cell, configuration, traffic mix or
metric sits in files of its own under the benchmark's folder, which the
harness finds from ``BENCHMARK.json`` at the root:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the sizes, the value type, the least bytes, and ``generator``, the
  module ``matrices/<generator>.py`` that builds the matrix and holds
  its plain reference product;
* ``traffic/<traffic>.json``: the mix that ``closed_loop`` drives;
* ``workloads/<cell>.json``: the limits of the numbers compared;
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` for
  each metric that ``BENCHMARK.json`` gives the cell.

A run: set-up (timed phase by phase), the measured window, with
``trace`` a profiled segment of the same loop and the dispatch bursts,
then the program's state freed and the comparison with the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import random
import time
from pathlib import Path

import numpy as np
import torch

import closed_loop
import devtrace
import reference

BENCH_DIR = "benchmark"


def seed_for(seed: int, *tags) -> int:
    """A 63-bit seed for one use (``tags``) of the run's ``--seed``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, tag))
    return g


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """A cell as its files describe it."""
    name: str
    cfg: dict
    mix: dict
    limits: dict
    matrix: object                  # the matrices/<generator>.py module
    metrics: list                   # BENCHMARK.json entries that apply
    readers: dict                   # name -> metrics/<name>.py module

    @property
    def kind(self) -> str:
        return closed_loop.kind_of(self.mix)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg["dtype"])


def find_cell(root: Path, name: str, trace: bool) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], entry["config"], "configuration")
    cfg = json.loads((root / conf["file"]).read_text())
    bdir = root / BENCH_DIR
    mix = json.loads((bdir / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    limits = json.loads((bdir / "workloads" / f"{name}.json")
                        .read_text())["limits"]
    matrix = load_module(bdir / "matrices" / f"{cfg['generator']}.py")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if _applies(m, name)]
    readers = {m["name"]: load_module(bdir / "metrics" / f"{m['name']}.py")
               for m in metrics}
    return Cell(name, cfg, mix, limits, matrix, metrics, readers)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    num_rows: int
    nnz: int
    setup: dict                     # phase -> seconds
    setup_s: float
    window: closed_loop.Segment
    traced: closed_loop.Segment | None = None
    trace: devtrace.Trace | None = None
    dispatch_s: list | None = None

    @property
    def kind(self) -> str:
        return self.cell.kind

    @property
    def lanes(self) -> int:
        return int(self.cell.mix["lanes"])


def _host_csr(problem):
    from tpusparse_torch.formats.csr import CsrMatrix

    return CsrMatrix(problem["num_rows"], problem["num_cols"],
                     problem["row_offsets"], problem["col_indices"],
                     problem["values"])


def set_up(cell: Cell, seed: int, device, phases: dict):
    """Build the matrix, the plan and the inputs and warm up; returns
    (problem, plan, loop). ``phases`` gets each phase's seconds."""
    from tpusparse_torch.ops.spmv import plan_kind, plan_matrix, spmv

    def phase(name, t):
        now = time.perf_counter()
        phases[name] = now - t
        return now

    t = time.perf_counter()
    torch.empty(1, device=device)
    closed_loop.sync(device)
    t = phase("cuda_init", t)
    # the first kernel call of the process loads (or builds) the library
    tiny = _host_csr({"num_rows": 2, "num_cols": 2,
                      "row_offsets": np.array([0, 1, 2], np.int32),
                      "col_indices": np.array([0, 1], np.int32),
                      "values": np.ones(2, getattr(np, cell.cfg["dtype"]))})
    spmv(plan_matrix(tiny, device=device),
         torch.ones(2, dtype=cell.dtype, device=device))
    closed_loop.sync(device)
    t = phase("library_load", t)
    problem = cell.matrix.generate(cell.cfg, generator(seed, "matrix",
                                                       device), device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = phase("matrix_build", t)
    plan = plan_matrix(_host_csr(problem), dtype=cell.dtype,
                       L=int(cell.mix["lanes"]), device=device)
    closed_loop.sync(device)
    t = phase("plan_matrix", t)
    print(f"plan_kind: {plan_kind(plan)}", flush=True)
    inputs = closed_loop.make_inputs(
        cell.mix, cell.matrix, cell.cfg, problem,
        generator(seed, "inputs", device), cell.dtype, device)
    loop = closed_loop.ClosedLoop(cell.mix, plan, inputs,
                                  random.Random(seed_for(seed, "order")),
                                  device)
    closed_loop.sync(device)
    t = phase("inputs", t)
    loop.warm_up()
    phase("warm_up", t)
    return problem, plan, loop


def numbers(cell: Cell, problem, inputs, answers, unconverged: int) -> dict:
    """The numbers compared, each {value, limit}: ``answers``
    (``closed_loop.Answer``) of the cell's ``inputs``, and the count of
    solves that did not converge."""
    cfg, mm = cell.cfg, cell.matrix

    def matmat(V, absolute=False):
        return mm.reference_matmat(cfg, problem, V, absolute=absolute)

    out = {}
    if cell.kind == "product":
        out["rel_err"] = reference.product_rel_err(
            matmat, inputs, [a.out for a in answers])
    else:
        out["unconverged"] = float(unconverged)
        true_max, gap_max = 0.0, 0.0
        tol = float(cell.mix["tolerance"])
        for a in answers:
            true, rep = reference.solve_residuals(
                matmat, inputs[a.source], a.out, a.reported)
            true_max = max(true_max, float(true.max()))
            gap_max = max(gap_max, float((true - rep).abs().max()) / tol)
        out["true_resid"] = true_max
        out["resid_gap"] = gap_max
    return {k: {"value": v, "limit": float(cell.limits[k])}
            for k, v in out.items()}


def _finite(v):
    return v if v is None or math.isfinite(v) else None


def json_number(v: float):
    """``v``, or its name where JSON has no number for it."""
    return v if math.isfinite(v) else repr(v)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, clock0: float, phases: dict) -> dict:
    """One run of cell ``name``; returns the result's fields."""
    device = torch.device(device)
    cell = find_cell(root, name, trace)
    problem, plan, loop = set_up(cell, seed, device, phases)
    setup_s = time.perf_counter() - clock0
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; setup_s {setup_s:.3f} s", flush=True)
    samples = closed_loop.Reservoir(int(cell.mix["check_samples"]),
                                    random.Random(seed_for(seed, "sample")))
    window = loop.run(seconds=seconds, reservoir=samples)
    window.answers = samples.items
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    run = Run(cell, problem["num_rows"], int(problem["col_indices"].shape[0]),
              dict(phases), setup_s, window)
    if trace:
        run.traced, run.trace = devtrace.capture(
            lambda: loop.run(ops=int(cell.mix["trace_ops"])), device)
        if cell.kind == "product":
            run.dispatch_s = loop.dispatch_seconds()
    metrics = {}
    for m in cell.metrics:
        v = _finite(cell.readers[m["name"]].read(run))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # free the program's state before the reference runs
    loop.plan = None
    del plan
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = numbers(cell, problem, loop.inputs, window.answers,
                     window.unconverged)
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": window.ops,
        "failed": window.unconverged,
        "metrics": metrics,
        "memory_peak_bytes": memory_peak,
        "checks": checks,
    }
    if run.trace is not None:
        out["trace"] = run.trace
    return out
