"""Time K3 and K3d (the port's merge-path SpMM) for whichever
``tpusparse_torch`` comes first on the path, or A/B several trees.

Cells, at the shapes where the main path launches them:
  * lap3d-160 at L = 16, float32 (K3) and float64 (K3d);
  * rmat-18-ef16 at L = 16, float32 (K3) and float64 (K3d);
  * the RCM inner plan of fem2d-30000 (``make_fem2d(30000, seed=1)``
    under ``reorder='auto'``) in float64 at L = 1 (K3d), with K2d's
    ``spmv`` on the same plan beside it;
  * the strict lower triangle of the IC(0) factor of scrambled
    lap3d-128 (RCM order), the Jacobi sweeps' operand, at L = 16 (K3).
Per cell: per call and graph-replayed device milliseconds of ``spmm`` as
a caller makes it and of ``torch.sparse`` CSR in the same type; the
bound (``bench/models.bound_ms``); a hash of Y's bytes, and whether Y is
within (nnz_i + 2) u (|A||X|)_i of a float64 product; and a
``torch.profiler`` split of ``spmm`` by kernel, as launches and device
microseconds per call. Prints the card's name and power limit and one
JSON line.

One tree:

    PYTHONPATH=/path/to/tree python3 scripts/torch_k3_ab.py [--ptxas]

``--ptxas`` also prints ``nvcc -Xptxas -v`` for the tree's
``csrc/merge_spmm.cu`` (registers, shared memory, spills).

An A/B of trees on one card: each tree's kernels are built first (three
trees at a time), the fixtures once (with the first tree), then the
trees run in the given order, each in its own process; the per-tree
medians (device ms of ``spmm``), the disagreement between a tree's runs
and the geometric means over the cells go to ``--out``:

    python3 scripts/torch_k3_ab.py --tree old=build/ab/old \\
        --tree new=. --order old,new,new,old --out build/k3_ab.json

Trees are made with ``git archive`` (the parent) and
``scripts/torch_k3_variants.py``.
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

from torch_k2_ab import _build_tree, _smi, _split

MATRICES = ("lap3d-160", "rmat-18-ef16", "fem2d-30000-rcm",
            "lap3d-128-jacobi-lower")
# (matrix, value type, L, kernel)
CELLS = (("lap3d-160", "float32", 16, "K3"),
         ("lap3d-160", "float64", 16, "K3d"),
         ("rmat-18-ef16", "float32", 16, "K3"),
         ("rmat-18-ef16", "float64", 16, "K3d"),
         ("fem2d-30000-rcm", "float64", 1, "K3d"),
         ("lap3d-128-jacobi-lower", "float32", 16, "K3"))


def _cell_key(cell) -> str:
    name, _, L, kernel = cell
    return f"{name} L={L} {kernel}"


def make_fixtures(path: Path) -> None:
    """The four host CSR matrices, saved as numpy arrays."""
    from tpusparse_torch import ic0_factorize, plan_matrix
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.ops.reorder import permute_symmetric
    from tpusparse_torch.precond.trisolve import split_diag

    def fem2d_rcm():
        csr = gen.make_fem2d(30000, seed=1).to_csr()
        A = plan_matrix(csr, "auto", dtype=np.float64, reorder="auto", L=1,
                        device="cpu")
        assert A.order == "rcm"
        return A.permuted(csr)

    def jacobi_lower():
        csr = gen.make_laplacian_grid3d(128).to_csr()
        p = np.random.default_rng(5).permutation(csr.num_rows)
        scr = permute_symmetric(csr, p)
        A = plan_matrix(scr, "auto", reorder="auto", L=16, device="cpu",
                        dtype=np.float32)
        assert A.order == "rcm"
        return split_diag(ic0_factorize(A.permuted(scr)))[0]

    arrays = {}
    for name, make in (("lap3d-160",
                        lambda: gen.make_laplacian_grid3d(160).to_csr()),
                       ("rmat-18-ef16",
                        lambda: gen.make_rmat(18, edge_factor=16).to_csr()),
                       ("fem2d-30000-rcm", fem2d_rcm),
                       ("lap3d-128-jacobi-lower", jacobi_lower)):
        t0 = time.perf_counter()
        csr = make()
        print(f"fixture {name}: {csr.shape}, {csr.nnz} nnz, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
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
            for name in MATRICES}


def _ptxas(source: str = "merge_spmm.cu") -> str:
    """``nvcc -Xptxas -v`` of the tree's ``csrc/<source>``."""
    import tpusparse_torch
    from tpusparse_torch.kernels import _build

    src = Path(tpusparse_torch.__file__).parent / "csrc" / source
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"{src.stem}_ptxas.o"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-c", "-o", str(out), str(src)],
                       capture_output=True, text=True)
    return r.stdout + r.stderr


def run_tree(fixtures: Path, ptxas: bool) -> dict:
    import torch
    import tpusparse_torch
    from tpusparse_torch import plan_matrix, spmm, spmv
    from tpusparse_torch.bench.models import bound_ms, spmm_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.kernels import _build
    from tpusparse_torch.ops.reference import csr_matmat

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
    for cell in CELLS:
        name, dt, L, kernel = cell
        csr = mats[name]
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(34)
        X = torch.randn((csr.num_cols, L), generator=g, device="cuda",
                        dtype=dtype)
        M = plan_matrix(csr, "merge", dtype=getattr(np, dt), device="cuda")
        Y = spmm(M, X)
        args = (M.num_rows, M.row_offsets, M.col_indices)
        Y64 = csr_matmat(*args, M.values.double(), X.double())
        AX = csr_matmat(*args, M.values.abs().double(), X.abs().double())
        nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()[:, None]
        u = 2.0 ** -53 if dtype == torch.float64 else 2.0 ** -24
        res = {"row_bound_ok": bool(
            ((Y.double() - Y64).abs() <= (nnz_i + 2) * u * AX).all()),
            "sha256": hashlib.sha256(
                Y.cpu().numpy().tobytes()).hexdigest()[:16]}
        del Y, Y64, AX, nnz_i
        lib = torch.sparse_csr_tensor(M.row_offsets, M.col_indices,
                                      M.values, size=csr.shape)
        fns = [("spmm", lambda: spmm(M, X)), ("torch.sparse", lambda: lib @ X)]
        if L == 1:
            x = X[:, 0].contiguous()
            fns.append(("K2d spmv" if dt == "float64" else "K2 spmv",
                        lambda: spmv(M, x)))
        for key, fn in fns:
            res[key] = {"ms": cuda_time_ms(fn), "device_ms": graph_time_ms(fn)}
        try:
            res["split"] = _split(lambda: spmm(M, X))
        except RuntimeError as e:  # a card whose profiler cannot trace
            res["split"] = {"error": str(e)}
        res["bound_ms"], res["bound_by"] = bound_ms(
            spmv_flops(csr.nnz, L),
            spmm_bytes(csr.nnz, csr.num_rows, csr.num_cols, L,
                       dtype.itemsize), fp64=dtype == torch.float64)
        print(f"{_cell_key(cell)}: {res}", flush=True)
        out[_cell_key(cell)] = res
        del M, lib, X
        torch.cuda.empty_cache()
    return out


def ab(trees: dict, order: list, out_path: Path, fixtures: Path,
       ptxas: bool, script: Path | None = None, summarize=None) -> None:
    """Build every tree, then run them in ``order`` on one card, each
    run ``script`` (this one by default) in its own process; the
    geometric means over the cells compare each tree with the first and
    the second of ``order`` (``summarize``, this script's by default)."""
    script = script or Path(__file__).resolve()
    summarize = summarize or _summarize
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
              f"{r.stdout[-8000:]}{r.stderr[-3000:]}", flush=True)
        if r.returncode:
            raise SystemExit(f"tree {name} failed")
        runs.append((name, json.loads(r.stdout.strip().splitlines()[-1])))
    summary = summarize(trees, order, runs, built)
    out_path.write_text(json.dumps({"summary": summary, "runs": runs}))
    print(json.dumps(summary))


def _summarize(trees: dict, order: list, runs: list, built: dict) -> dict:
    summary = {"card": runs[0][1]["card"], "order": order, "built": built,
               "cells": {}}
    for key in map(_cell_key, CELLS):
        row = {}
        for name in trees:
            mine = [r[key] for n, r in runs if n == name]
            dev = [m["spmm"]["device_ms"] for m in mine]
            row[name] = {
                "spmm_device_ms": dev,
                "spmm_ms": [m["spmm"]["ms"] for m in mine],
                "torch.sparse_device_ms": [m["torch.sparse"]["device_ms"]
                                           for m in mine],
                "median": statistics.median(dev),
                "disagreement": (max(dev) - min(dev)) / min(dev),
                "sha256": sorted({m["sha256"] for m in mine}),
                "row_bound_ok": all(m["row_bound_ok"] for m in mine)}
        summary["cells"][key] = row
    spread = max(max(c[n]["disagreement"] for n in trees)
                 for c in summary["cells"].values())
    summary["spread"] = max(spread, 0.02)
    summary["geomean_vs"] = {
        ref: {n: float(np.exp(np.mean([
            np.log(c[n]["median"] / c[ref]["median"])
            for c in summary["cells"].values()]))) for n in trees}
        for ref in dict.fromkeys(order[:2])}
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixtures", type=Path,
                    default=Path("build") / "k3_ab_fixtures.npz")
    ap.add_argument("--make-fixtures", type=Path)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a tree for the A/B")
    ap.add_argument("--order", help="comma-separated tree names")
    ap.add_argument("--out", type=Path,
                    default=Path("build") / "k3_ab.json")
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
