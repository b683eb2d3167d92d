#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

Drives the port's main path — host ingest -> ``plan_matrix(csr,
"auto")`` -> ``spmv`` / ``cg_solve`` — through its hand-written CUDA
kernels, and exits non-zero on any failure. Run from the repository
root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed on its own lines:

  [1] the card (``nvidia-smi`` name and power limit) and the kernels'
      build from ``tpusparse_torch/csrc``;
  [2] K1 (masked DIA) and K2 (merge-path SpMV) against their plain
      PyTorch versions on the card, under the stated error bounds
      (u = 2^-24); two K2 runs must be bitwise equal;
  [3] the slice at the bench fixture lap3d-48: AUTO must give a masked
      DIA plan; SpMV times (CUDA events per call as made, and device
      time from CUDA-graph replay) beside the plain versions';
  [4] the slice at lap3d-160 (4.1M rows, beyond L2): the same SpMV
      times, then CG on AUTO (must converge, float64 true residual
      < 1e-4) and CG through K2 on rmat_spd(17, 4) and gr_30_30, each
      solved twice and timed on the second solve;
  [5] launch counts of phases 3-4 (counters reset before phase 3):
      both kernels must have run on the main path.

The last two lines are a JSON object of the kernels and the result
line ``{"ok": true, "device": {...}}``. The port imports no JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
U = 2.0 ** -24           # float32 unit roundoff
CG_TOL = 1e-5
TRUE_RESIDUAL_MAX = 1e-4


def check(ok, what: str) -> None:
    if not bool(ok):
        raise RuntimeError(f"chip_smoke FAILED: {what}")


def rand(seed: int, shape) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def k1_vs_plain(name, D, L, seed):
    """K1 against its plain version: |d|_i <= 2 K u (|A||x|)_i."""
    from tpusparse_torch.kernels import dia_stream

    XT = rand(seed, (L, D.num_cols))
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    Yp = dia_stream.spmm_dia_masked_plain(D, XT)
    absA = dataclasses.replace(D, vals=D.vals.abs())
    AX = dia_stream.spmm_dia_masked_plain(absA, XT.abs().double())
    err = (Y - Yp).abs()
    bound = 2 * len(D.offsets) * U * AX
    check((err.double() <= bound).all(), f"K1 {name} L={L} error bound")
    print(f"[2] K1 {name} L={L}: max|K1-plain| {float(err.max()):.3e} "
          f"(bound 2Ku|A||x| max {float(bound.max()):.3e}), bitwise equal "
          f"{bool(torch.equal(Y, Yp))}")
    return float(err.max())


def k2_vs_plain(name, csr, seed):
    """K2 against its plain version (ULP compare, normwise 1e-5) and a
    float64 product (|d|_i <= (nnz_i + 2) u (|A||x|)_i); two runs equal."""
    from tpusparse_torch.kernels import merge_spmv
    from tpusparse_torch.ops.reference import csr_matvec
    from tpusparse_torch.utils.compare import compare_results

    M = merge_spmv.to_device_merge(csr, "cuda")
    x = rand(seed, M.num_cols)
    y1 = merge_spmv.merge_matvec(M, x)
    y2 = merge_spmv.merge_matvec(M, x)
    yp = merge_spmv.spmv_merge_plain(M, x)
    args = (M.num_rows, M.row_offsets, M.col_indices)
    y64 = csr_matvec(*args, M.values.double(), x.double())
    ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
    nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()
    err = float((y1 - yp).abs().max()) if M.num_rows else 0.0
    amax = float(ax.max()) if M.num_rows else 0.0
    check(torch.equal(y1, y2), f"K2 {name}: two runs bitwise equal")
    check(compare_results(y1, yp)[0], f"K2 {name}: ULP compare vs plain")
    check(err <= 1e-5 * amax, f"K2 {name}: normwise bound vs plain")
    check(((y1.double() - y64).abs() <= (nnz_i + 2) * U * ax).all(),
          f"K2 {name}: row bound vs float64")
    print(f"[2] K2 {name} {M.num_rows}x{M.num_cols} nnz {M.nnz}: "
          f"max|K2-plain| {err:.3e} (normwise {err / max(amax, 1e-30):.2e}"
          f" <= 1e-5), row bound vs float64 PASS, bitwise repeat PASS")
    return err


def time_pair(kernel_fn, plain_fn):
    """(kernel, plain) ms: events per call as made, and graph-replayed
    device time; measured plain, kernel, kernel, plain."""
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms

    out = {}
    for key, fn in (("plain", plain_fn), ("kernel", kernel_fn),
                    ("kernel", kernel_fn), ("plain", plain_fn)):
        ev, dev = cuda_time_ms(fn), graph_time_ms(fn)
        out.setdefault(key, []).append((ev, dev))
    return {k: (sum(e for e, _ in v) / 2, sum(d for _, d in v) / 2)
            for k, v in out.items()}


def slice_spmv(phase, tag, csr, seed):
    """AUTO (must be masked DIA) and merge SpMV through ``spmv``: check
    against float64, time beside the plain versions."""
    from tpusparse_torch import plan_kind, plan_matrix, spmv
    from tpusparse_torch.bench.models import gflops, spmv_flops
    from tpusparse_torch.kernels import dia_stream, merge_spmv
    from tpusparse_torch.ops.reference import csr_matvec

    A = plan_matrix(csr, "auto", device="cuda")
    check(plan_kind(A) == "dia" and isinstance(A.dia,
                                               dia_stream.DiaStreamDevice),
          f"{tag}: AUTO gives a masked DIA plan (got {plan_kind(A)})")
    M = plan_matrix(csr, "merge", device="cuda")
    x = rand(seed, csr.num_cols)
    args = (M.num_rows, M.row_offsets, M.col_indices)
    y64 = csr_matvec(*args, M.values.double(), x.double())
    ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
    for label, P in (("auto", A), ("merge", M)):
        y = spmv(P, x)
        check(torch.isfinite(y).all() and y.shape == (csr.num_rows,),
              f"{tag} {label}: finite y of shape ({csr.num_rows},)")
        check(((y.double() - y64).abs() <= 16 * U * ax).all(),
              f"{tag} {label}: y within 16u|A||x| of float64")
    XT = x.reshape(1, -1)
    times = {
        "K1": time_pair(lambda: spmv(A, x),
                        lambda: dia_stream.spmm_dia_masked_plain(A.dia, XT)),
        "K2": time_pair(lambda: spmv(M, x),
                        lambda: merge_spmv.spmv_merge_plain(M, x)),
    }
    fl = spmv_flops(csr.nnz)
    for k, label in (("K1", "auto (masked DIA)"), ("K2", "merge")):
        (kev, kdev), (pev, pdev) = times[k]["kernel"], times[k]["plain"]
        print(f"[{phase}] {tag} spmv {label}: kernel {kev:.4f} ms/call "
              f"({gflops(fl, kev * 1e-3):.1f} GFLOP/s), device "
              f"{kdev:.4f} ms ({gflops(fl, kdev * 1e-3):.1f} GFLOP/s); "
              f"plain {pev:.4f} ms/call, device {pdev:.4f} ms")
    return A, M, times


def run_cg(tag, A, csr, b):
    """CG at tol 1e-5 through ``cg_solve``, twice (the first solve pays
    one-time costs: module loads, allocator growth); checks and times the
    second. Returns (iters, ms/iter, float64 true residual)."""
    from tpusparse_torch import cg_solve

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve(A, b, max_iters=10000, tolerance=CG_TOL)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    first, ms = walls
    A64 = csr.to_scipy().astype(np.float64)
    b64 = b.double().cpu().numpy()
    x64 = res.x.double().cpu().numpy()
    true_res = float(np.linalg.norm(b64 - A64 @ x64) / np.linalg.norm(b64))
    check(res.converged, f"{tag}: CG converged")
    check(np.isfinite(x64).all(), f"{tag}: finite x")
    check(true_res < TRUE_RESIDUAL_MAX, f"{tag}: true residual {true_res}")
    per = ms / max(res.iterations, 1)
    print(f"[4] cg {tag}: {res.iterations} iterations, converged, "
          f"residual {res.residual:.3e}, float64 true residual "
          f"{true_res:.3e}, {ms:.1f} ms ({per:.4f} ms/iteration; first "
          f"solve {first:.1f} ms)")
    return res.iterations, per, true_res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.io.market import read_market
    from tpusparse_torch.kernels import _build, dia_stream, merge_spmv

    # [1] card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("[1] card (nvidia-smi name, power.limit):")
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s"
          f" (nvcc {_build.NVCC_FLAGS[1]}, {len(_build.sources())} sources)",
          flush=True)

    # [2] kernels against their plain versions
    lap48 = gen.make_laplacian_grid3d(48).to_csr()
    D48 = plan_matrix(lap48, "auto", device="cuda").dia
    k1_err = max(k1_vs_plain("lap3d-48", D48, L, 10 + L) for L in (1, 4))
    fixtures = [("lap3d-48", lap48),
                ("rmat-18-ef16", gen.make_rmat(18, edge_factor=16).to_csr()),
                ("wheel-100000", gen.make_wheel(100000).to_csr())]
    fixtures += [(p.stem, read_market(p).to_csr())
                 for p in sorted((ROOT / "data" / "real").glob("*.mtx"))]
    k2_err = max(k2_vs_plain(name, csr, 20 + i)
                 for i, (name, csr) in enumerate(fixtures))
    torch.cuda.synchronize()

    # [3]-[4] the main path; count launches from here on
    dia_stream.LAUNCHES = 0
    merge_spmv.LAUNCHES = 0
    slice_spmv(3, "lap3d-48", lap48, 30)
    lap160 = gen.make_laplacian_grid3d(160).to_csr()
    A160, _, t160 = slice_spmv(4, "lap3d-160", lap160, 31)
    x_true = np.random.default_rng(32).standard_normal(lap160.num_cols)
    b = torch.from_numpy((lap160.to_scipy() @ x_true).astype(np.float32))
    run_cg("lap3d-160 auto (K1)", A160, lap160, b.cuda())
    for tag, csr in (("rmat_spd-17-ef4 merge (K2)",
                      gen.make_rmat_spd(17, edge_factor=4).to_csr()),
                     ("gr_30_30 merge (K2)",
                      read_market(ROOT / "data/real/gr_30_30.mtx").to_csr())):
        b = rand(33, csr.num_rows)
        run_cg(tag, plan_matrix(csr, "merge", device="cuda"), csr, b)
    torch.cuda.synchronize()

    # [5] launch counts of the main path
    n1, n2 = dia_stream.LAUNCHES, merge_spmv.LAUNCHES
    print(f"[5] main-path launches: K1 {n1}, K2 {n2}")
    check(n1 > 0 and n2 > 0, "both kernels launched on the main path")

    kernels = [
        {"name": "K1 masked DIA SpMV", "route": "cuda",
         "source": "tpusparse_torch/csrc/dia_masked.cu",
         "replaces": "tpusparse/kernels/dia_stream.py:809",
         "launches": n1, "max_abs_err": k1_err,
         "ms": t160["K1"]["kernel"][1], "plain_ms": t160["K1"]["plain"][1],
         "fixture": "lap3d-160 spmv, device time"},
        {"name": "K2 merge-path CSR SpMV", "route": "cuda",
         "source": "tpusparse_torch/csrc/merge_spmv.cu",
         "replaces": "tpusparse/kernels/merge_spmv.py:672",
         "launches": n2, "max_abs_err": k2_err,
         "ms": t160["K2"]["kernel"][1], "plain_ms": t160["K2"]["plain"][1],
         "fixture": "lap3d-160 spmv, device time"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
