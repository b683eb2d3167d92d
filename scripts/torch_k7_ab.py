"""Time K7 (the port's n-major masked DIA SpMM) and K6 (its row
permutation) for whichever ``tpusparse_torch`` comes first on the path,
or A/B several trees.

K7 cells, Y = A X on (n, L) float32 blocks (``nmajor_matmat``), at the
shapes of the n-major path and around it:
  * lap3d-160 at L = 16 (``chip_smoke.py`` [14]), L = 4 and L = 3 (odd
    L: lane groups of one value);
  * lap3d-128 at L = 16 ([14]'s PCG shape);
  * lap3d-64 at L = 128 (the widest plan: 262,144 rows, 134 MB of x);
  * lap2d-2000 at L = 16 (5 planes, the +-2000 ones 128 KB away).
K6 cells, on the RCM permutation that ``reorder='auto'`` plans for
scrambled lap3d-160 (``chip_smoke.py`` [12]) at L = 1 and 16 in float32
and at L = 1 in float64, and for scrambled lap3d-128 ([13], the PCG
shape) at L = 16: the gather ``permute_apply`` and, where the tree has
it (round 1's trees, which carried a first K6 design with
``permute_bijection``), the scatter through the inverse permutation.
Per cell: per call and graph-replayed device milliseconds of the kernel;
the one PyTorch call that computes the same function (``torch.sparse``
CSR on X (n, L) for K7, ``index_select`` for K6); the bound
(``bench/models.bound_ms`` on ``dia_masked_bytes`` / ``permute_bytes``);
a hash of Y's bytes and whether Y equals the plain version bit for bit.
Then ``cg_solve_multi`` on the n-major plan of lap3d-160 at L = 16, tol
1e-5, on B = A X_true made by the plain version from a seeded X_true on
the card (the same bits in every tree), solved twice: iterations and ms
an iteration of each solve. Prints the card's name and power limit and
one JSON line.

One tree:

    PYTHONPATH=/path/to/tree python3 scripts/torch_k7_ab.py [--ptxas]

``--ptxas`` also prints ``nvcc -Xptxas -v`` for the tree's
``csrc/dia_nmajor.cu`` and ``csrc/permute.cu`` (registers, shared
memory, spills).

An A/B of trees on one card: each tree's kernels are built first (three
trees at a time), the fixtures once (with the first tree; RCM of two
scrambled matrices, about a minute of host time), then the trees run in
the given order, each in its own process; the per-tree medians
(graph-replayed device ms), the disagreement between a tree's runs and
the geometric means over the K7 cells and over the K6 gather cells go to
``--out``:

    python3 scripts/torch_k7_ab.py --tree old=build/ab/old \\
        --tree new=. --order old,new,new,old --out build/k7_ab.json

Trees are made with ``git archive`` (the parent) and
``scripts/torch_k7_variants.py``.
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

# name -> generator call of a masked band
BANDS = {"lap3d-160": ("make_laplacian_grid3d", 160),
         "lap3d-128": ("make_laplacian_grid3d", 128),
         "lap3d-64": ("make_laplacian_grid3d", 64),
         "lap2d-2000": ("make_laplacian_grid2d", 2000)}
# (band, L): K7's timed cells
K7_CELLS = (("lap3d-160", 16), ("lap3d-128", 16), ("lap3d-160", 4),
            ("lap3d-160", 3), ("lap3d-64", 128), ("lap2d-2000", 16))
# name -> grid of a scrambled lap3d whose RCM permutation K6 applies
PERMS = {"lap3d-160": 160, "lap3d-128": 128}
# (perm, value type, L): K6's cells (L = 1 is a vector)
K6_CELLS = (("lap3d-160", "float32", 1), ("lap3d-160", "float32", 16),
            ("lap3d-160", "float64", 1), ("lap3d-128", "float32", 16))
SOLVE_KEY = "cg_solve_multi nmajor lap3d-160 L=16"


def _k7_key(cell) -> str:
    return f"K7 {cell[0]} L={cell[1]}"


def _k6_key(cell, route) -> str:
    name, dt, L = cell
    return f"K6 {route} {name} RCM {dt} L={L}"


def make_fixtures(path: Path) -> None:
    """Each band's mask words, offsets and coefficients, and each RCM
    permutation (of the lap3d scrambled by ``default_rng(5)``, as
    ``chip_smoke.py`` scrambles it), saved as numpy arrays."""
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.ops.reorder import permute_symmetric, rcm_order

    arrays = {}
    for name, (make, width) in BANDS.items():
        csr = getattr(gen, make)(width).to_csr()
        B = plan_matrix(csr, "nmajor", L=2, dtype=np.float32,
                        device="cpu").dia.band
        arrays.update({f"{name}/mask": B.mask.numpy(),
                       f"{name}/offsets": np.array(B.offsets),
                       f"{name}/vals": np.array(B.vals_host),
                       f"{name}/nnz": np.array(csr.nnz)})
    for name, width in PERMS.items():
        t0 = time.perf_counter()
        csr = gen.make_laplacian_grid3d(width).to_csr()
        p = np.random.default_rng(5).permutation(csr.num_rows)
        arrays[f"{name}/rcm"] = rcm_order(permute_symmetric(csr, p))
        print(f"fixture RCM of scrambled {name}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    np.savez(path, **arrays)


def _band(z, name, L, dev):
    from tpusparse_torch.kernels import dia_nmajor, dia_stream

    words = z[f"{name}/mask"]
    n = words.shape[0]
    band = dia_stream.from_mask_words(n, n, z[f"{name}/offsets"],
                                      z[f"{name}/vals"], words, dev)
    return dia_nmajor.DiaNMajorDevice(band, dia_nmajor.padded_lane_count(L))


def _library_csr(D):
    """``torch.sparse`` CSR of the masked band on its device."""
    import torch

    B = D.band
    n = B.num_rows
    i = torch.arange(n, device=B.mask.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(B.offsets):
        ok = (((B.mask >> k) & 1) != 0) & (i + off >= 0) & (i + off < n)
        rows.append(i[ok])
        cols.append(i[ok] + off)
        vals.append(B.vals[k].expand(int(ok.sum())))
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _times(fn) -> dict:
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms

    return {"ms": cuda_time_ms(fn), "device_ms": graph_time_ms(fn)}


def _k7_cells(z) -> dict:
    import torch
    from tpusparse_torch.bench.models import (
        bound_ms,
        dia_masked_bytes,
        spmv_flops,
    )
    from tpusparse_torch.kernels import dia_nmajor

    out = {}
    for cell in K7_CELLS:
        name, L = cell
        D = _band(z, name, L, "cuda")
        n = D.num_rows
        g = torch.Generator(device="cuda").manual_seed(70 + L)
        X = torch.randn((n, L), generator=g, device="cuda")
        Y = dia_nmajor.nmajor_matmat(D.band, X)
        res = {"bitwise_plain": bool(torch.equal(
            Y, dia_nmajor.spmm_nmajor_plain(D.band, X))), "sha256": _digest(Y)}
        del Y
        torch.cuda.empty_cache()
        lib = _library_csr(D)
        res["kernel"] = _times(lambda: dia_nmajor.nmajor_matmat(D.band, X))
        res["torch.sparse"] = _times(lambda: lib @ X)
        res["bound_ms"], res["bound_by"] = bound_ms(
            spmv_flops(int(lib.values().numel()), L), dia_masked_bytes(n, L))
        print(f"{_k7_key(cell)}: {res}", flush=True)
        out[_k7_key(cell)] = res
        del D, lib, X
        torch.cuda.empty_cache()
    return out


def _k6_cells(z) -> dict:
    import torch
    from tpusparse_torch.bench.models import bound_ms, permute_bytes
    from tpusparse_torch.kernels import permute

    scatter = hasattr(permute, "permute_bijection")
    out = {}
    for cell in K6_CELLS:
        name, dt, L = cell
        perm = z[f"{name}/rcm"]
        n = perm.shape[0]
        p = permute.build_permute_plan(perm, "cuda")
        inv = permute.build_permute_plan(np.argsort(perm), "cuda")
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(80 + L)
        X = torch.randn((n,) if L == 1 else (n, L), generator=g,
                        device="cuda", dtype=dtype)
        want = X.index_select(0, p)
        library = _times(lambda: X.index_select(0, p))
        bound = bound_ms(0.0, permute_bytes(n, L, dtype.itemsize))
        routes = {"gather": lambda: permute.permute_apply(p, X)}
        if scatter:
            routes["scatter"] = lambda: permute._launch(inv, X, True)
        for route, fn in routes.items():
            res = {"bitwise_plain": bool(torch.equal(fn(), want)),
                   "kernel": _times(fn), "index_select": library,
                   "bound_ms": bound[0], "bound_by": bound[1]}
            print(f"{_k6_key(cell, route)}: {res}", flush=True)
            out[_k6_key(cell, route)] = res
        del X, want, p, inv
        torch.cuda.empty_cache()
    return out


def _solve(z) -> dict:
    """``cg_solve_multi`` on the n-major plan of lap3d-160 at L = 16."""
    import torch
    from tpusparse_torch import cg_solve_multi
    from tpusparse_torch.kernels import dia_nmajor
    from tpusparse_torch.ops.hybrid import HybridPlan

    D = _band(z, "lap3d-160", 16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(45)
    X_true = torch.randn((D.num_rows, 16), generator=g, device="cuda")
    B = dia_nmajor.spmm_nmajor_plain(D.band, X_true)
    W = HybridPlan(D, None, int(z["lap3d-160/nnz"]))
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve_multi(W, B, tolerance=1e-5)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out.append({"iterations": int(res.iterations),
                    "ms_per_iteration": 1e3 * dt / max(int(res.iterations),
                                                       1),
                    "converged": bool(res.converged.all()),
                    "x_sha256": _digest(res.x)})
    return {"solves": out}


def run_tree(fixtures: Path, ptxas: bool) -> dict:
    import tpusparse_torch
    from tpusparse_torch.kernels import _build

    smi = _smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    out = {"package": tpusparse_torch.__file__, "card": smi,
           "build_s": time.perf_counter() - t0}
    if ptxas:
        out["ptxas"] = (torch_k3_ab._ptxas("dia_nmajor.cu")
                        + torch_k3_ab._ptxas("permute.cu"))
        print(out["ptxas"], flush=True)
    z = np.load(fixtures)
    out.update(_k7_cells(z))
    out.update(_k6_cells(z))
    out[SOLVE_KEY] = _solve(z)
    print(f"{SOLVE_KEY}: {out[SOLVE_KEY]}", flush=True)
    return out


def _geomean(cells: dict, keys, num: str, den: str) -> float:
    return float(np.exp(np.mean([np.log(cells[k][num]["median"]
                                        / cells[k][den]["median"])
                                 for k in keys])))


def summarize(trees: dict, order: list, runs: list, built: dict) -> dict:
    """Per cell and tree: device ms of each run, the median, the
    disagreement between runs, Y's hashes; the spread per cell (its
    largest disagreement, at least 2 %); the geometric means of each
    tree's medians over those of the first and the second tree of
    ``order``, over K7's cells and over K6's gather cells; the solves per
    tree."""
    summary = {"card": runs[0][1]["card"], "order": order, "built": built,
               "cells": {}, "solve": {}}
    keys = [_k7_key(c) for c in K7_CELLS] + [
        _k6_key(c, r) for c in K6_CELLS for r in ("gather", "scatter")]
    for key in keys:
        row = {}
        for name in trees:
            mine = [r[key] for n, r in runs if n == name and key in r]
            if not mine:
                continue
            dev = [m["kernel"]["device_ms"] for m in mine]
            lib = mine[0].get("torch.sparse", mine[0].get("index_select"))
            row[name] = {
                "device_ms": dev, "ms": [m["kernel"]["ms"] for m in mine],
                "library_device_ms": lib["device_ms"],
                "bound_ms": mine[0]["bound_ms"],
                "median": statistics.median(dev),
                "disagreement": (max(dev) - min(dev)) / min(dev),
                "sha256": sorted({m.get("sha256", "") for m in mine}),
                "bitwise_plain": all(m["bitwise_plain"] for m in mine)}
        row["spread"] = max([0.02] + [v["disagreement"]
                                      for v in row.values()])
        summary["cells"][key] = row
    cells = summary["cells"]
    summary["spread"] = max(c["spread"] for c in cells.values())
    groups = {"K7": [_k7_key(c) for c in K7_CELLS],
              "K6 gather": [_k6_key(c, "gather") for c in K6_CELLS]}
    summary["geomean_vs"] = {
        group: {ref: {n: _geomean(cells, ks, n, ref) for n in trees}
                for ref in dict.fromkeys(order[:2])}
        for group, ks in groups.items()}
    for name in trees:
        summary["solve"][name] = [r[SOLVE_KEY] for n, r in runs if n == name]
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixtures", type=Path,
                    default=Path("build") / "k7_ab_fixtures.npz")
    ap.add_argument("--make-fixtures", type=Path)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a tree for the A/B")
    ap.add_argument("--order", help="comma-separated tree names")
    ap.add_argument("--out", type=Path, default=Path("build") / "k7_ab.json")
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
