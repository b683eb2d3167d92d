"""Time K5 and K5d (the port's value-plane DIA kernels) for whichever
``tpusparse_torch`` comes first on the path, or A/B several trees.

Cells, each on the (L, n) layout of ``spmm_dia_planes_t``, at the shapes
where the main path launches the kernels:
  * var-7-160 (``make_variable_stencil(160, dims=3, shift=1.0,
    seed=0)``: 4,096,000 rows, 7 planes) at L = 1 and L = 16 with
    float32 and bf16 planes (K5), and float64 planes (K5d);
  * var-27-128 (``make_variable_stencil(128, dims=3, full=True,
    shift=1.0, seed=2)``: 2,097,152 rows, 27 planes) at L = 1 with
    float32 and bf16 planes;
  * var-7-161 (4,173,281 rows, odd n: three lanes in four start off a
    16-byte boundary) at L = 16 with float32 planes;
  * K1 and K1d at lap3d-160, L = 1 and 16, by Y's hash only (the shared
    row helpers of ``csrc/dia_rows.cuh`` must leave them unchanged).
Per cell: per call and graph-replayed device milliseconds of the kernel;
``torch.sparse`` CSR of the same matrix in the same type (float32 for
bf16 planes, with the bf16 values) on X (n, L); the bound
(``bench/models.bound_ms`` on ``dia_planes_bytes``); a hash of Y's bytes
and whether Y equals the plain version bit for bit. Then
``cg_solve_multi`` at var-7-160, L = 16, tol 1e-5 (``chip_smoke.py``'s
[9]) on a right-hand side made on the host (the same bits in every
run), solved twice: iterations and ms an iteration of the second solve.
Prints the card's name and power limit and one JSON line.

One tree:

    PYTHONPATH=/path/to/tree python3 scripts/torch_k5_ab.py [--ptxas]

``--ptxas`` also prints ``nvcc -Xptxas -v`` for the tree's
``csrc/dia_planes.cu`` (registers, shared memory, spills).

An A/B of trees on one card: each tree's kernels are built first (three
trees at a time), the fixtures once (with the first tree; about a
minute of host time), then the trees run in the given order, each in
its own process; the per-tree medians (graph-replayed device ms), the
disagreement between a tree's runs and the geometric means over the
timed cells go to ``--out``:

    python3 scripts/torch_k5_ab.py --tree old=build/ab/old \\
        --tree new=. --order old,new,new,old --out build/k5_ab.json

Trees are made with ``git archive`` (the parent) and
``scripts/torch_k5_variants.py``.
"""

import argparse
import hashlib
import json
import statistics
import time
from pathlib import Path

import numpy as np

import torch_k3_ab
from torch_k2_ab import _smi

MATRICES = {
    "var-7-160": dict(width=160, dims=3, shift=1.0, seed=0),
    "var-27-128": dict(width=128, dims=3, full=True, shift=1.0, seed=2),
    "var-7-161": dict(width=161, dims=3, shift=1.0, seed=0),
}
# (matrix, plane type, L, kernel): the timed cells
CELLS = (("var-7-160", "float32", 1, "K5"),
         ("var-7-160", "bfloat16", 1, "K5"),
         ("var-7-160", "float32", 16, "K5"),
         ("var-7-160", "bfloat16", 16, "K5"),
         ("var-27-128", "float32", 1, "K5"),
         ("var-27-128", "bfloat16", 1, "K5"),
         ("var-7-160", "float64", 1, "K5d"),
         ("var-7-160", "float64", 16, "K5d"),
         ("var-7-161", "float32", 16, "K5"))
# (value type, L, kernel): K1 and K1d at lap3d-160, by hash
K1_CELLS = (("float32", 1, "K1"), ("float32", 16, "K1"),
            ("float64", 1, "K1d"), ("float64", 16, "K1d"))
SOLVE_KEY = "cg_solve_multi var-7-160 L=16"


def _cell_key(cell) -> str:
    name, dt, L, kernel = cell
    return f"{name} {dt} L={L} {kernel}"


def _k1_key(cell) -> str:
    dt, L, kernel = cell
    return f"lap3d-160 {dt} L={L} {kernel}"


def make_fixtures(path: Path) -> None:
    """Each matrix's float64 value planes and offsets, and lap3d-160's
    masked operand, saved as numpy arrays."""
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.formats.dia import partition_dia, select_diagonals
    from tpusparse_torch.io import generators as gen

    arrays = {}
    for name, kw in MATRICES.items():
        t0 = time.perf_counter()
        csr = gen.make_variable_stencil(**kw).to_csr()
        host, rest = partition_dia(csr, select_diagonals(csr))
        assert rest.nnz == 0
        arrays.update({f"{name}/planes": np.asarray(host.data, np.float64),
                       f"{name}/offsets": np.array(host.offsets),
                       f"{name}/shape": np.array([csr.num_rows,
                                                  csr.num_cols])})
        print(f"fixture {name}: {csr.num_rows} rows, offsets "
              f"{tuple(host.offsets)}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    D = plan_matrix(gen.make_laplacian_grid3d(160).to_csr(), "auto",
                    dtype=np.float64, device="cpu").dia
    arrays.update({"lap3d-160/mask": D.mask.numpy(),
                   "lap3d-160/offsets": np.array(D.offsets),
                   "lap3d-160/vals": D.vals.numpy()})
    np.savez(path, **arrays)


def _planes(z, name, plane_dtype, dev):
    """The DiaDevice of a fixture in ``plane_dtype`` (bf16 rounds through
    float32, as ``formats.dia.to_device_dia`` does)."""
    import torch
    from tpusparse_torch.formats.dia import DiaDevice

    host = z[f"{name}/planes"]
    if plane_dtype != torch.float64:
        host = host.astype(np.float32)
    rows, cols = (int(s) for s in z[f"{name}/shape"])
    return DiaDevice(rows, cols, tuple(int(o) for o in z[f"{name}/offsets"]),
                     torch.from_numpy(host).to(plane_dtype).to(dev)
                     .contiguous())


def _library_csr(D, dtype):
    """``torch.sparse`` CSR of the value planes on their device, every
    in-range entry in ``dtype``."""
    import torch

    n, m = D.num_rows, D.num_cols
    rows, cols, vals = [], [], []
    i = torch.arange(n, device=D.data.device)
    for k, off in enumerate(D.offsets):
        ok = (i + off >= 0) & (i + off < m)
        rows.append(i[ok])
        cols.append(i[ok] + off)
        vals.append(D.data[k][ok].to(dtype))
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, m))
    return coo.coalesce().to_sparse_csr()


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _solve(z) -> dict:
    """[9]'s ``cg_solve_multi`` at var-7-160, L = 16, on B = A X_true
    made on the host in float64 and rounded to float32."""
    import scipy.sparse as sp
    import torch
    from tpusparse_torch import cg_solve_multi
    from tpusparse_torch.ops.hybrid import HybridPlan

    D = _planes(z, "var-7-160", torch.float32, "cuda")
    host = z["var-7-160/planes"]
    n = D.num_rows
    A = sp.dia_matrix((np.stack([np.roll(host[k], off) for k, off in
                                 enumerate(D.offsets)]),
                       list(D.offsets)), shape=(n, n)).tocsr()
    X_true = np.random.default_rng(45).standard_normal((n, 16))
    B = torch.from_numpy((A @ X_true).astype(np.float32)).cuda()
    W = HybridPlan(D, None, A.nnz)
    out = {}
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve_multi(W, B, tolerance=1e-5)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = {"iterations": int(res.iterations),
               "ms_per_iteration": 1e3 * dt / max(int(res.iterations), 1),
               "converged": bool(res.converged.all()),
               "x_sha256": _digest(res.x)}
    return out


def run_tree(fixtures: Path, ptxas: bool) -> dict:
    import torch
    import tpusparse_torch
    from tpusparse_torch.bench.models import (
        bound_ms,
        dia_planes_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.kernels import _build, dia_stream

    smi = _smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    out = {"package": tpusparse_torch.__file__, "card": smi,
           "build_s": time.perf_counter() - t0}
    if ptxas:
        out["ptxas"] = torch_k3_ab._ptxas("dia_planes.cu")
        print(out["ptxas"], flush=True)
    z = np.load(fixtures)
    for cell in CELLS:
        name, pdt, L, kernel = cell
        plane_dtype = getattr(torch, pdt)
        D = _planes(z, name, plane_dtype, "cuda")
        dtype = dia_stream.planes_value_dtype(D)
        g = torch.Generator(device="cuda").manual_seed(34)
        XT = torch.randn((L, D.num_cols), generator=g, device="cuda",
                         dtype=dtype)
        Y = dia_stream.spmm_dia_planes_t(D, XT)
        res = {"bitwise_plain": bool(torch.equal(
            Y, dia_stream.spmm_dia_planes_plain(D, XT))),
            "sha256": _digest(Y)}
        del Y
        torch.cuda.empty_cache()
        lib = _library_csr(D, dtype)
        X = XT.T.contiguous()
        for key, fn in (("kernel",
                         lambda: dia_stream.spmm_dia_planes_t(D, XT)),
                        ("torch.sparse", lambda: lib @ X)):
            res[key] = {"ms": cuda_time_ms(fn), "device_ms": graph_time_ms(fn)}
        nnz = int(lib.values().numel())
        res["bound_ms"], res["bound_by"] = bound_ms(
            spmv_flops(nnz, L),
            dia_planes_bytes(D.num_rows, D.num_cols, len(D.offsets), L,
                             D.data.element_size(), dtype.itemsize),
            fp64=dtype == torch.float64)
        print(f"{_cell_key(cell)}: {res}", flush=True)
        out[_cell_key(cell)] = res
        del D, lib, X, XT
        torch.cuda.empty_cache()
    words = z["lap3d-160/mask"]
    n = words.shape[0]
    for cell in K1_CELLS:
        dt, L, kernel = cell
        dtype = getattr(torch, dt)
        D = dia_stream.from_mask_words(n, n, z["lap3d-160/offsets"],
                                       z["lap3d-160/vals"], words, "cuda",
                                       dtype)
        g = torch.Generator(device="cuda").manual_seed(34)
        XT = torch.randn((L, n), generator=g, device="cuda", dtype=dtype)
        Y = dia_stream.spmm_dia_stream_t(D, XT)
        out[_k1_key(cell)] = {"sha256": _digest(Y), "bitwise_plain": bool(
            torch.equal(Y, dia_stream.spmm_dia_masked_plain(D, XT)))}
        print(f"{_k1_key(cell)}: {out[_k1_key(cell)]}", flush=True)
        del D, XT, Y
        torch.cuda.empty_cache()
    out[SOLVE_KEY] = _solve(z)
    print(f"{SOLVE_KEY}: {out[SOLVE_KEY]}", flush=True)
    return out


def summarize(trees: dict, order: list, runs: list, built: dict) -> dict:
    """Per timed cell and tree: device ms of each run, the median, the
    disagreement between runs, Y's hashes; the spread per cell (its
    largest disagreement, at least 2 %) and over all cells; the geometric
    means of each tree's medians over those of the first and the second
    tree of ``order``; K1's hashes and the solves per tree."""
    summary = {"card": runs[0][1]["card"], "order": order, "built": built,
               "cells": {}, "k1": {}, "solve": {}}
    for key in map(_cell_key, CELLS):
        row = {}
        for name in trees:
            mine = [r[key] for n, r in runs if n == name]
            dev = [m["kernel"]["device_ms"] for m in mine]
            row[name] = {
                "device_ms": dev,
                "ms": [m["kernel"]["ms"] for m in mine],
                "torch.sparse_device_ms": [m["torch.sparse"]["device_ms"]
                                           for m in mine],
                "bound_ms": mine[0]["bound_ms"],
                "median": statistics.median(dev),
                "disagreement": (max(dev) - min(dev)) / min(dev),
                "sha256": sorted({m["sha256"] for m in mine}),
                "bitwise_plain": all(m["bitwise_plain"] for m in mine)}
        row["spread"] = max(0.02, max(row[n]["disagreement"]
                                      for n in trees))
        summary["cells"][key] = row
    summary["spread"] = max(c["spread"] for c in summary["cells"].values())
    summary["geomean_vs"] = {
        ref: {n: float(np.exp(np.mean([
            np.log(c[n]["median"] / c[ref]["median"])
            for c in summary["cells"].values()]))) for n in trees}
        for ref in dict.fromkeys(order[:2])}
    for key in map(_k1_key, K1_CELLS):
        summary["k1"][key] = {
            name: sorted({r[key]["sha256"] for n, r in runs if n == name})
            for name in trees}
    for name in trees:
        summary["solve"][name] = [r[SOLVE_KEY] for n, r in runs if n == name]
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixtures", type=Path,
                    default=Path("build") / "k5_ab_fixtures.npz")
    ap.add_argument("--make-fixtures", type=Path)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a tree for the A/B")
    ap.add_argument("--order", help="comma-separated tree names")
    ap.add_argument("--out", type=Path, default=Path("build") / "k5_ab.json")
    args = ap.parse_args()
    if args.make_fixtures:
        make_fixtures(args.make_fixtures)
        return
    if args.tree:
        trees = {}
        for spec in args.tree:
            name, path = spec.split("=", 1)
            trees[name] = Path(path).resolve()
        torch_k3_ab.ab(trees, args.order.split(","), args.out.resolve(),
                       args.fixtures.resolve(), args.ptxas,
                       script=Path(__file__).resolve(), summarize=summarize)
        return
    if not args.fixtures.exists():
        args.fixtures.parent.mkdir(parents=True, exist_ok=True)
        make_fixtures(args.fixtures)
    print(json.dumps(run_tree(args.fixtures, args.ptxas)))


if __name__ == "__main__":
    main()
