"""Time K1 and K1d (the port's masked DIA kernels) for whichever
``tpusparse_torch`` comes first on the path, or A/B several trees.

Cells, at the shapes where the main path launches them, each on the
(L, n) layout of ``spmm_dia_stream_t``:
  * lap3d-160 at L = 1 and L = 16, float32 (K1) and float64 (K1d);
  * lap2d-2049 (``make_laplacian_grid2d(2049)``: 4,198,401 rows, odd n,
    offsets +-1 and +-2049) at L = 16, float32 (K1);
  * HPCG's 27-point band (nine runs of three consecutive offsets) at
    208^3 (8,998,912 rows, the benchmark's ``hpcg-27pt-208``) at L = 1
    and L = 16, float64 (K1d), and at 128^3 at L = 16, float32 (K1).
Per cell: per call and graph-replayed device milliseconds of the kernel;
``torch.sparse`` CSR of the same matrix in the same type on X (n, L)
(not at 208^3, whose 240M nonzeros would cost each run minutes);
the bound (``bench/models.bound_ms`` on ``dia_masked_bytes``); a hash of
Y's bytes and whether Y equals the plain version bit for bit; and a
``torch.profiler`` split of the call by kernel, as launches and device
microseconds per call. Prints the card's name and power limit and one
JSON line.

One tree:

    PYTHONPATH=/path/to/tree python3 scripts/torch_k1_ab.py [--ptxas]

``--ptxas`` also prints ``nvcc -Xptxas -v`` for the tree's
``csrc/dia_masked.cu`` (registers, shared memory, spills).

``--solves`` instead runs the solves of ``chip_smoke.py``'s [7] and
[11] at lap3d-160, L = 16, on a right-hand side made on the host
(scipy, float64: the same bits in every run) from the seeded X of
[11]: ``cg_solve_multi`` (K1) to 1e-5 and ``cg_solve_multi_refined``
(K1 inner, K1d residuals) to 1e-12, twice each, and prints their
iteration counts and a hash of X. It also builds [11]'s own right-hand
side twice (``csr_matmat``, whose ``index_add_`` adds in float64 with
atomics) and prints whether the two are equal bit for bit.

An A/B of trees on one card: each tree's kernels are built first (three
trees at a time), the fixtures once (with the first tree), then the
trees run in the given order, each in its own process; the per-tree
medians (graph-replayed device ms), the disagreement between a tree's
runs and the geometric means over the cells go to ``--out``:

    python3 scripts/torch_k1_ab.py --tree old=build/ab/old \\
        --tree new=. --order old,new,new,old --out build/k1_ab.json

Trees are made with ``git archive`` (the parent) and
``scripts/torch_k1_variants.py``.
"""

import argparse
import hashlib
import json
import time
from pathlib import Path

import numpy as np

import torch_k3_ab
from torch_k2_ab import _smi, _split

# (matrix, value type, L, kernel)
CELLS = (("lap3d-160", "float32", 1, "K1"),
         ("lap3d-160", "float32", 16, "K1"),
         ("lap3d-160", "float64", 1, "K1d"),
         ("lap3d-160", "float64", 16, "K1d"),
         ("lap2d-2049", "float32", 16, "K1"),
         ("hpcg27-208", "float64", 1, "K1d"),
         ("hpcg27-208", "float64", 16, "K1d"),
         ("hpcg27-128", "float32", 16, "K1"))
# matrices timed without the torch.sparse yardstick
NO_LIBRARY = ("hpcg27-208",)


def _cell_key(cell) -> str:
    name, _, L, kernel = cell
    return f"{name} L={L} {kernel}"


def hpcg27_band(width: int) -> tuple:
    """(offsets, float64 values, mask words) of HPCG's 27-point stencil
    on a width^3 grid as AUTO plans it, built directly: the 27 offsets
    (dz width + dy) width + dx ascending, 26 on offset 0 and -1 on the
    others, bit k of a row's word set where neighbour k lies in the
    grid."""
    n = width ** 3
    i = np.arange(n, dtype=np.int64)
    coords = (i % width, i // width % width, i // (width * width))
    planes = sorted(((dz * width + dy) * width + dx, (dx, dy, dz))
                    for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dx in (-1, 0, 1))
    words = np.zeros(n, np.uint32)
    for k, (_, step) in enumerate(planes):
        inside = np.ones(n, bool)
        for c, d in zip(coords, step):
            inside &= (c + d >= 0) & (c + d < width)
        words |= inside.astype(np.uint32) << np.uint32(k)
    offsets = np.array([off for off, _ in planes])
    return offsets, np.where(offsets == 0, 26.0, -1.0), words


def make_fixtures(path: Path) -> None:
    """The masked operands (mask words, offsets, float64 coefficients)
    of the matrices, saved as numpy arrays."""
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.io import generators as gen

    arrays = {}
    for width in (208, 128):
        t0 = time.perf_counter()
        offsets, vals, words = hpcg27_band(width)
        name = f"hpcg27-{width}"
        arrays.update({f"{name}/mask": words.view(np.int32),
                       f"{name}/offsets": offsets, f"{name}/vals": vals})
        print(f"fixture {name}: {words.shape[0]} rows, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, make in (("lap3d-160", lambda: gen.make_laplacian_grid3d(160)),
                       ("lap2d-2049",
                        lambda: gen.make_laplacian_grid2d(2049))):
        t0 = time.perf_counter()
        D = plan_matrix(make().to_csr(), "auto", dtype=np.float64,
                        device="cpu").dia
        arrays.update({f"{name}/mask": D.mask.numpy(),
                       f"{name}/offsets": np.array(D.offsets),
                       f"{name}/vals": D.vals.numpy()})
        print(f"fixture {name}: {D.num_rows} rows, offsets {D.offsets}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    np.savez(path, **arrays)


def _library_csr(D, dtype):
    """``torch.sparse`` CSR of the masked operand on its device."""
    import torch

    n = D.num_rows
    rows, cols, vals = [], [], []
    for k, off in enumerate(D.offsets):
        i = torch.nonzero((D.mask >> k) & 1).flatten()
        i = i[(i + off >= 0) & (i + off < n)]
        rows.append(i)
        cols.append(i + off)
        vals.append(torch.full(i.shape, float(D.vals_host[k]), dtype=dtype,
                               device=i.device))
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def run_tree(fixtures: Path, ptxas: bool) -> dict:
    import torch
    import tpusparse_torch
    from tpusparse_torch.bench.models import (
        bound_ms,
        dia_masked_bytes,
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
        out["ptxas"] = torch_k3_ab._ptxas("dia_masked.cu")
        print(out["ptxas"], flush=True)
    z = np.load(fixtures)
    for cell in CELLS:
        name, dt, L, kernel = cell
        dtype = getattr(torch, dt)
        words = z[f"{name}/mask"]
        n = words.shape[0]
        D = dia_stream.from_mask_words(n, n, z[f"{name}/offsets"],
                                       z[f"{name}/vals"], words, "cuda",
                                       dtype)
        g = torch.Generator(device="cuda").manual_seed(34)
        XT = torch.randn((L, n), generator=g, device="cuda", dtype=dtype)
        Y = dia_stream.spmm_dia_stream_t(D, XT)
        res = {"bitwise_plain": bool(torch.equal(
            Y, dia_stream.spmm_dia_masked_plain(D, XT))),
            "sha256": hashlib.sha256(
                Y.cpu().numpy().tobytes()).hexdigest()[:16]}
        del Y
        fns = {"kernel": lambda: dia_stream.spmm_dia_stream_t(D, XT)}
        lib = X = None
        if name not in NO_LIBRARY:
            lib = _library_csr(D, dtype)
            X = XT.T.contiguous()
            fns["torch.sparse"] = lambda: lib @ X
        res["torch.sparse"] = None
        for key, fn in fns.items():
            res[key] = {"ms": cuda_time_ms(fn), "device_ms": graph_time_ms(fn)}
        try:
            res["split"] = _split(lambda: dia_stream.spmm_dia_stream_t(D, XT))
        except RuntimeError as e:  # a card whose profiler cannot trace
            res["split"] = {"error": str(e)}
        nnz = sum(int(((D.mask >> k) & 1).sum())
                  for k in range(len(D.offsets)))
        res["bound_ms"], res["bound_by"] = bound_ms(
            spmv_flops(nnz, L), dia_masked_bytes(n, L, dtype.itemsize),
            fp64=dtype == torch.float64)
        print(f"{_cell_key(cell)}: {res}", flush=True)
        out[_cell_key(cell)] = res
        del D, lib, X, XT
        torch.cuda.empty_cache()
    return out


def solves() -> dict:
    """Iteration counts of [7]'s and [11]'s solves on a right-hand side
    with the same bits in every run (see the module docstring)."""
    import torch
    from tpusparse_torch import (
        cg_solve_multi,
        cg_solve_multi_refined,
        plan_matrix,
    )
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.ops.reference import csr_matmat

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    csr = gen.make_laplacian_grid3d(160).to_csr()
    X_true = np.random.default_rng(57).standard_normal((csr.num_cols, 16))
    B = torch.from_numpy(csr.to_scipy() @ X_true).cuda()
    M32 = plan_matrix(csr, "auto", L=16, device="cuda", dtype=np.float32)
    M64 = plan_matrix(csr, "auto", dtype=np.float64, L=16, device="cuda")
    out = {"card": _smi(), "B_sha256": digest(B)}
    for i in range(2):
        res = cg_solve_multi(M32, B.float(), tolerance=1e-5)
        out[f"cg_solve_multi {i}"] = {"iterations": int(res.iterations),
                                      "x_sha256": digest(res.x)}
        res = cg_solve_multi_refined(M32, M64, B, tolerance=1e-12)
        out[f"cg_solve_multi_refined {i}"] = {
            "refinements": res.refinements,
            "inner_iterations": int(res.inner_iterations),
            "x_sha256": digest(res.x)}
        print(out, flush=True)
    C64 = plan_matrix(csr, "reference", dtype=np.float64, device="cuda")
    X = torch.from_numpy(X_true).cuda()
    B1, B2 = (csr_matmat(C64.num_rows, C64.row_offsets, C64.col_indices,
                         C64.values, X) for _ in range(2))
    out["csr_matmat_B_repeats_bitwise"] = bool(torch.equal(B1, B2))
    out["csr_matmat_B_sha256"] = [digest(B1), digest(B2)]
    return out


def summarize(trees: dict, order: list, runs: list, built: dict) -> dict:
    """Per cell and tree: device ms of each run, the median, the
    disagreement between runs, Y's hashes; the spread (the largest
    disagreement, at least 2 %) and the geometric means of each tree's
    medians over the first and the second tree of ``order``."""
    import statistics

    summary = {"card": runs[0][1]["card"], "order": order, "built": built,
               "cells": {}}
    for key in map(_cell_key, CELLS):
        row = {}
        for name in trees:
            mine = [r[key] for n, r in runs if n == name]
            dev = [m["kernel"]["device_ms"] for m in mine]
            row[name] = {
                "device_ms": dev,
                "ms": [m["kernel"]["ms"] for m in mine],
                "torch.sparse_device_ms": [
                    m["torch.sparse"] and m["torch.sparse"]["device_ms"]
                    for m in mine],
                "bound_ms": mine[0]["bound_ms"],
                "median": statistics.median(dev),
                "disagreement": (max(dev) - min(dev)) / min(dev),
                "sha256": sorted({m["sha256"] for m in mine}),
                "bitwise_plain": all(m["bitwise_plain"] for m in mine)}
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
                    default=Path("build") / "k1_ab_fixtures.npz")
    ap.add_argument("--make-fixtures", type=Path)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a tree for the A/B")
    ap.add_argument("--order", help="comma-separated tree names")
    ap.add_argument("--out", type=Path, default=Path("build") / "k1_ab.json")
    args = ap.parse_args()
    if args.make_fixtures:
        make_fixtures(args.make_fixtures)
        return
    if args.solves:
        print(json.dumps(solves()))
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
