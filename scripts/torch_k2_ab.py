"""Time K2 and K2d (the port's merge-path SpMV) at L = 1 for whichever
``tpusparse_torch`` comes first on the path, or A/B several trees.

Cells: lap3d-160 and rmat-18-ef16, float32 (K2) and float64 (K2d). Per
cell: the merge plan's build seconds and, where the tree's plan has one,
its tile search's; per call and graph-replayed device milliseconds of
the kernel alone (``merge_matvec``) and of ``spmv`` as a caller makes
it; ``torch.sparse`` CSR in the same type; the bound
(``bench/models.bound_ms``); a hash of y's bytes, and whether y is
within (nnz_i + 2) u (|A||x|)_i of a float64 product; and a
``torch.profiler`` split of ``spmv`` by kernel (search, consume, fix-up,
elementwise multiply), as launches and device microseconds per call.
Prints the card's name and power limit and one JSON line.

One tree:

    PYTHONPATH=/path/to/tree python3 scripts/torch_k2_ab.py [--ptxas]

``--ptxas`` also prints ``nvcc -Xptxas -v`` for the tree's
``csrc/merge_spmv.cu`` (registers, shared memory, spills).

An A/B of trees in one process tree on one card: each tree's kernels are
built first (three trees at a time), the fixtures once, then the trees
run in the given order, each in its own process, and the per-tree
medians (device ms of ``spmv``) and the disagreement between a tree's
runs go to ``--out``:

    python3 scripts/torch_k2_ab.py --tree old=build/ab/old \\
        --tree new=. --order old,new,new,old --out build/k2_ab.json
"""

import argparse
import concurrent.futures
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CELLS = (("lap3d-160", "float32", "K2"), ("lap3d-160", "float64", "K2d"),
         ("rmat-18-ef16", "float32", "K2"),
         ("rmat-18-ef16", "float64", "K2d"))
SPLIT_CALLS = 20


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def make_fixtures(path: Path) -> None:
    """The two host CSR matrices, saved as numpy arrays."""
    from tpusparse_torch.io import generators as gen

    arrays = {}
    for name, make in (("lap3d-160",
                        lambda: gen.make_laplacian_grid3d(160)),
                       ("rmat-18-ef16",
                        lambda: gen.make_rmat(18, edge_factor=16))):
        csr = make().to_csr()
        arrays.update({f"{name}/row_offsets": csr.row_offsets,
                       f"{name}/col_indices": csr.col_indices,
                       f"{name}/values": csr.values,
                       f"{name}/shape": np.array(csr.shape)})
    np.savez(path, **arrays)


def _load(path: Path):
    from tpusparse_torch import CsrMatrix

    z = np.load(path)
    return {name: CsrMatrix(*(int(s) for s in z[f"{name}/shape"]),
                            z[f"{name}/row_offsets"],
                            z[f"{name}/col_indices"], z[f"{name}/values"])
            for name in ("lap3d-160", "rmat-18-ef16")}


def _split(fn) -> dict:
    """Launches and device microseconds per call of each kernel that
    ``fn`` runs, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPLIT_CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key[:90]] = {"launches": e.count / SPLIT_CALLS,
                               "us": us / SPLIT_CALLS}
    return out


def _ptxas() -> str:
    import tpusparse_torch
    from tpusparse_torch.kernels import _build

    src = Path(tpusparse_torch.__file__).parent / "csrc" / "merge_spmv.cu"
    out = Path(os.environ.get("TMPDIR", "/tmp")) / "k2_ptxas.o"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-c", "-o", str(out), str(src)],
                       capture_output=True, text=True)
    return r.stdout + r.stderr


def run_tree(fixtures: Path, ptxas: bool) -> dict:
    import torch
    import tpusparse_torch
    from tpusparse_torch import plan_matrix, spmv
    from tpusparse_torch.bench.models import bound_ms, spmm_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.kernels import _build, merge_spmv
    from tpusparse_torch.ops.reference import csr_matvec

    smi = _smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    out = {"package": tpusparse_torch.__file__, "card": smi,
           "build_s": time.perf_counter() - t0}
    if ptxas:
        out["ptxas"] = _ptxas()
        print(out["ptxas"], flush=True)
    mats = _load(fixtures)
    for name, dt, kernel in CELLS:
        csr = mats[name]
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(34)
        x = torch.randn(csr.num_cols, generator=g, device="cuda",
                        dtype=dtype)
        t0 = time.perf_counter()
        M = plan_matrix(csr, "merge", dtype=getattr(np, dt), device="cuda")
        torch.cuda.synchronize()
        cell = {"plan_s": time.perf_counter() - t0}
        if hasattr(merge_spmv, "merge_tile_coords"):
            t0 = time.perf_counter()
            merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz)
            cell["tile_search_s"] = time.perf_counter() - t0
        y = merge_spmv.merge_matvec(M, x)
        args = (M.num_rows, M.row_offsets, M.col_indices)
        y64 = csr_matvec(*args, M.values.double(), x.double())
        ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
        nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()
        u = 2.0 ** -53 if dtype == torch.float64 else 2.0 ** -24
        cell["row_bound_ok"] = bool(
            ((y.double() - y64).abs() <= (nnz_i + 2) * u * ax).all())
        cell["sha256"] = hashlib.sha256(
            y.cpu().numpy().tobytes()).hexdigest()[:16]
        del y64, ax, nnz_i
        lib = torch.sparse_csr_tensor(M.row_offsets, M.col_indices,
                                      M.values, size=csr.shape)
        for key, fn in (("kernel", lambda: merge_spmv.merge_matvec(M, x)),
                        ("spmv", lambda: spmv(M, x)),
                        ("torch.sparse", lambda: lib @ x)):
            cell[key] = {"ms": cuda_time_ms(fn), "device_ms": graph_time_ms(fn)}
        try:
            cell["split"] = _split(lambda: spmv(M, x))
        except RuntimeError as e:  # a card whose profiler cannot trace
            cell["split"] = {"error": str(e)}
        cell["bound_ms"], cell["bound_by"] = bound_ms(
            spmv_flops(csr.nnz),
            spmm_bytes(csr.nnz, csr.num_rows, csr.num_cols, 1,
                       dtype.itemsize), fp64=dtype == torch.float64)
        print(f"{name} {kernel}: {cell}", flush=True)
        out[f"{name} {kernel}"] = cell
        del M, lib, x
        torch.cuda.empty_cache()
    return out


def _build_tree(root: Path) -> str:
    r = subprocess.run(
        [sys.executable, "-c",
         "from tpusparse_torch.kernels import _build; print(_build.build())"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
        capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"build of {root} failed:\n{r.stderr[-4000:]}")
    return r.stdout.strip()


def ab(trees: dict, order: list, out_path: Path, fixtures: Path,
       ptxas: bool) -> None:
    """Build every tree, then run them in ``order`` on one card; the
    geometric means over the cells compare each tree with the first and
    the second of ``order``."""
    script = Path(__file__).resolve()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fixtures.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        built = dict(zip(trees, pool.map(_build_tree, trees.values())))
    print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    env0 = {**os.environ, "PYTHONPATH": str(next(iter(trees.values())))}
    subprocess.run([sys.executable, str(script), "--make-fixtures",
                    str(fixtures)], env=env0, check=True)
    runs = []
    for i, name in enumerate(order):
        cmd = [sys.executable, str(script), "--fixtures", str(fixtures)]
        if ptxas and name not in order[:i]:
            cmd.append("--ptxas")
        r = subprocess.run(cmd, env={**os.environ,
                                     "PYTHONPATH": str(trees[name])},
                           capture_output=True, text=True)
        print(f"--- run {i} tree {name} rc {r.returncode}\n"
              f"{r.stdout[-6000:]}{r.stderr[-3000:]}", flush=True)
        if r.returncode:
            raise SystemExit(f"tree {name} failed")
        runs.append((name, json.loads(r.stdout.strip().splitlines()[-1])))
    summary = {"card": runs[0][1]["card"], "order": order, "built": built,
               "cells": {}}
    for _, kernel_cell in ((c, f"{c[0]} {c[2]}") for c in CELLS):
        row = {}
        for name in trees:
            mine = [r[kernel_cell] for n, r in runs if n == name]
            dev = [m["spmv"]["device_ms"] for m in mine]
            row[name] = {
                "spmv_device_ms": dev,
                "kernel_device_ms": [m["kernel"]["device_ms"] for m in mine],
                "spmv_ms": [m["spmv"]["ms"] for m in mine],
                "torch.sparse_device_ms": [m["torch.sparse"]["device_ms"]
                                           for m in mine],
                "median": statistics.median(dev),
                "disagreement": (max(dev) - min(dev)) / min(dev),
                "sha256": sorted({m["sha256"] for m in mine}),
                "row_bound_ok": all(m["row_bound_ok"] for m in mine)}
        summary["cells"][kernel_cell] = row
    spread = max(max(c[n]["disagreement"] for n in trees)
                 for c in summary["cells"].values())
    summary["spread"] = max(spread, 0.02)
    summary["geomean_vs"] = {
        ref: {n: float(np.exp(np.mean([
            np.log(c[n]["median"] / c[ref]["median"])
            for c in summary["cells"].values()]))) for n in trees}
        for ref in dict.fromkeys(order[:2])}
    out_path.write_text(json.dumps({"summary": summary, "runs": runs}))
    print(json.dumps(summary))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixtures", type=Path,
                    default=Path("build") / "k2_ab_fixtures.npz")
    ap.add_argument("--make-fixtures", type=Path)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a tree for the A/B")
    ap.add_argument("--order", help="comma-separated tree names")
    ap.add_argument("--out", type=Path,
                    default=Path("build") / "k2_ab.json")
    args = ap.parse_args()
    if args.make_fixtures:
        make_fixtures(args.make_fixtures)
        return
    if args.tree:
        trees = {}
        for spec in args.tree:
            name, path = spec.split("=", 1)
            trees[name] = Path(path).resolve()
        ab(trees, args.order.split(","), args.out.resolve(),
           args.fixtures.resolve(), args.ptxas)
        return
    if not args.fixtures.exists():
        args.fixtures.parent.mkdir(parents=True, exist_ok=True)
        make_fixtures(args.fixtures)
    print(json.dumps(run_tree(args.fixtures, args.ptxas)))


if __name__ == "__main__":
    main()
