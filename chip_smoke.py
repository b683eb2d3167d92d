#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

Drives the port's two main paths through its hand-written CUDA kernels
and exits non-zero on any failure:

  * one right-hand side: host ingest -> ``plan_matrix(csr, "auto")`` ->
    ``spmv`` / ``cg_solve`` (K1 masked DIA, K2 merge-path SpMV);
  * L right-hand sides: ``plan_matrix(csr, strategy, L=16)`` -> ``spmm``
    / ``cg_solve_multi`` (K1 at L > 1, K3 merge-path SpMM, K4 row-split
    SpMM);
  * variable-coefficient diagonal operators, one right-hand side: AUTO
    -> ``spmv`` / ``cg_solve`` on float32 value planes, and
    ``plan_dia_bf16`` -> ``cg_solve_bf16`` / ``cg_solve_refined_f32`` on
    bf16 planes (K5 value-plane DIA);
  * the same operators at L = 16: ``spmm`` / ``cg_solve_multi`` (K5);
  * float64, one right-hand side: ``plan_matrix(csr, dtype=np.float64)``
    -> ``spmv`` / ``cg_solve`` / ``cg_solve_refined`` (K1d, K2d and K5d,
    the float64 twins of K1, K2 and K5, with float32 inner solves);
  * float64 at L = 16: ``spmm`` / ``cg_solve_multi_refined`` (K1d, K3d,
    K4d).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed on its own lines:

  [1] the card (``nvidia-smi`` name and power limit) and the kernels'
      build from ``tpusparse_torch/csrc``;
  [2] every kernel against its plain PyTorch version on the card, under
      the stated error bounds (u = 2^-24): K1 at L = 1, 4 and 16; K2,
      and K3 and K4 at L = 1, 3, 16 and 32, on lap3d-48, rmat-18-ef16,
      wheel-100000, ``data/real/*.mtx``, an empty-rows and an nnz = 0
      CSR; two runs of K2, K3 and K4 must be bitwise equal; K5 with
      float32 and bf16 planes at L = 1, 4 and 16 on var-7-48, var-27-32,
      Trefethen_200, a rectangular band and the DIA part of a hybrid,
      bitwise equal to its plain version and within 2Ku|A||x| of
      float64; the float64 twins at L = 1, 3 and 16 (u = 2^-53): K1d on
      lap3d-48 and K5d on K5's fixtures bitwise equal to their plain
      versions, K2d, K3d and K4d on K2's fixtures within
      2(nnz_i + 2)u|A||x| of theirs and bitwise repeatable, all five
      within that bound of an independent float64 product;
  [3] the single-RHS slice at the bench fixture lap3d-48: AUTO must give
      a masked DIA plan; SpMV times (CUDA events per call as made, and
      device time from CUDA-graph replay) beside the plain versions', the
      ``torch.sparse`` CSR product's (the library call, never on the
      path) and the bound (bytes or operations over the H100's peaks,
      ``bench/models.bound_ms``);
  [4] the same at lap3d-160 (4.1M rows, beyond L2), then CG on AUTO
      (must converge, float64 true residual < 1e-4) and CG through K2
      on rmat_spd(17, 4) and gr_30_30, each solved twice and timed on
      the second solve;
  [6] the multi-RHS slice at L = 16: ``spmm`` at lap3d-160 on AUTO (must
      be a pure masked DIA plan: K1), ``'merge'`` (K3) and
      ``'row_split'`` (K4), and at rmat-18-ef16 on AUTO (must plan
      merge: K3) and ``'row_split'`` (K4); each result checked against a
      float64 product and timed beside its plain version, the library
      call and the bound;
  [7] ``cg_solve_multi`` at L = 16, tol 1e-5: lap3d-160 on AUTO (K1,
      (L, n) state) with B = A X_true, rmat_spd(17, 4) on AUTO (K3) and
      gr_30_30 on ``'row_split'`` (K4); every lane must converge with a
      float64 true residual < 1e-4; solved twice, the second timed;
  [8] the variable-coefficient single-RHS path on var-7-160 (4.1M rows,
      7 planes) and var-27-128 (2.1M rows, 27 planes): AUTO must plan
      value planes (K5) and ``plan_dia_bf16`` bf16 planes; ``spmv`` on
      each timed beside the plain version, ``torch.sparse`` and the
      bound; f32 ``cg_solve`` on both, ``cg_solve_bf16`` and
      ``cg_solve_refined_f32`` on var-27-128, each converged with a
      float64 true residual < 1e-4 on the exact operator;
  [9] the same at L = 16 on var-7-160: ``spmm`` (K5 alone on (L, n)
      and through ``spmm``) and ``cg_solve_multi`` with (L, n) state;
 [10] float64, one right-hand side: lap3d-160 (AUTO must plan K1d:
      ``spmv`` timed beside the plain version, ``torch.sparse`` in
      float64 and the float64 bound; ``cg_solve`` to 1e-10;
      ``cg_solve_refined`` with the K1 float32 plan inside to 1e-12),
      var-7-160 (AUTO must plan K5d: ``spmv``, ``cg_solve_refined``
      with K5 inside), rmat-18-ef16 (``spmv`` on ``'merge'``: K2d) and
      rmat_spd-17-ef4 (AUTO must plan merge: ``cg_solve`` on K2d,
      ``cg_solve_refined`` with K2 inside); every refinement must reach
      a float64 true residual < 1e-11;
 [11] float64 at L = 16: ``spmm`` on lap3d-160 AUTO (K1d on (L, n)),
      on rmat-18-ef16 ``'merge'`` (K3d) and ``'row_split'`` (K4d);
      ``cg_solve_multi_refined`` on lap3d-160 to 1e-12 on every lane;
  [5] launch counts of each main path, counted from 0 just before it
      ([3]-[4], [6]-[7], [8], [9], [10] and [11]) and read just after:
      K1 and K2 must have run on the first, K1, K3 and K4 on the
      second, K5 on the third and the fourth, K1d, K2d and K5d on the
      fifth, K1d, K3d and K4d on the sixth.

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
import scipy.sparse as sp
import torch

ROOT = Path(__file__).resolve().parent
U = 2.0 ** -24           # float32 unit roundoff
U64 = 2.0 ** -53         # float64 unit roundoff
CG_TOL = 1e-5
TRUE_RESIDUAL_MAX = 1e-4
CG64_TOL = 1e-10         # float64 CG
CG64_TRUE_MAX = 1e-9
REFINE_TOL = 1e-12       # float64 refinements
REFINE_TRUE_MAX = 1e-11
L_MULTI = 16             # right-hand sides of the multi-RHS phases
SPMM_LS = (1, 3, 16, 32)
F64_LS = (1, 3, 16)


def check(ok, what: str) -> None:
    if not bool(ok):
        raise RuntimeError(f"chip_smoke FAILED: {what}")


def rand(seed: int, shape) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def rand64(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape)).cuda()


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


def dia_planes_of(csr, plane_dtype=torch.float32):
    """The DIA part of a host CSR as K5's value planes on the card."""
    from tpusparse_torch.formats.dia import (
        partition_dia,
        select_diagonals,
        to_device_dia,
    )

    host, _ = partition_dia(csr, select_diagonals(csr))
    return to_device_dia(host, "cuda", plane_dtype)


def k5_vs_plain(name, D, L, seed):
    """K5 against its plain version, bitwise, and against float64 on the
    same (upcast) planes: |d|_i <= 2 K u (|A||x|)_i."""
    from tpusparse_torch.kernels import dia_stream

    XT = rand(seed, (L, D.num_cols))
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    Yp = dia_stream.spmm_dia_planes_plain(D, XT)
    Y64 = dia_stream.spmm_dia_planes_plain(D, XT.double())
    AX = dia_stream.spmm_dia_planes_plain(
        dataclasses.replace(D, data=D.data.abs()), XT.abs().double())
    err = (Y.double() - Y64).abs()
    bound = 2 * len(D.offsets) * U * AX
    what = f"K5 {name} {str(D.data.dtype)[6:]} planes L={L}"
    check(Y.shape == (L, D.num_rows) and torch.isfinite(Y).all(),
          f"{what}: finite Y of shape ({L}, {D.num_rows})")
    check(torch.equal(Y, Yp), f"{what}: bitwise equal to plain")
    check((err <= bound).all(), f"{what}: within 2Ku|A||x| of float64")
    print(f"[2] {what}: bitwise equal to plain, max|K5-float64| "
          f"{float(err.max()):.3e} (bound max {float(bound.max()):.3e})")
    return float((Y - Yp).abs().max())


def plane_fixtures(gen, read_market):
    """(name, host CSR) of K5's checks: variable stencils, Trefethen_200
    (offsets to +-128), a rectangular band (x longer than y) and a
    hybrid (var-7-48 plus scattered symmetric entries, whose DIA part
    K5 runs)."""
    from tpusparse_torch import CsrMatrix

    rng = np.random.default_rng(7)
    n, m = 3000, 3005
    rect = sp.diags([rng.uniform(-2, 2, min(n, m - o) - max(0, -o))
                     for o in (-7, 0, 5)], (-7, 0, 5), shape=(n, m)).tocsr()
    var48 = gen.make_variable_stencil(48).to_csr()
    S = var48.to_scipy()
    r, c = rng.integers(0, S.shape[0], 3000), rng.integers(0, S.shape[0],
                                                         3000)
    E = sp.coo_matrix((np.full(6000, 0.01), (np.r_[r, c], np.r_[c, r])),
                      shape=S.shape)
    hyb = (S + E).tocsr()
    return [
        ("var-7-48", var48),
        ("var-27-32", gen.make_variable_stencil(32, full=True,
                                                seed=2).to_csr()),
        ("Trefethen_200",
         read_market(ROOT / "data/real/Trefethen_200.mtx").to_csr()),
        ("rect-3000x3005", CsrMatrix(n, m, rect.indptr, rect.indices,
                                     rect.data)),
        ("hybrid-var-7-48", CsrMatrix(hyb.shape[0], hyb.shape[1],
                                      hyb.indptr, hyb.indices, hyb.data)),
    ]


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


def spmm_kernels():
    """name -> (plan constructor, kernel wrapper, plain version) of K3, K4."""
    from tpusparse_torch.kernels import ell_spmm, merge_spmv, spmm_merge

    return {
        "K3": (merge_spmv.to_device_merge, spmm_merge.merge_matmat,
               spmm_merge.spmm_merge_plain),
        "K4": (ell_spmm.to_device_row_split, ell_spmm.row_split_matmat,
               ell_spmm.spmm_row_split_plain),
    }


def row_bound(A, X):
    """(float64 A X, (nnz_i + 2) u |A||X|) for a CSR operand on the card."""
    from tpusparse_torch.ops.reference import csr_matmat

    args = (A.num_rows, A.row_offsets, A.col_indices)
    Y64 = csr_matmat(*args, A.values.double(), X.double())
    AX = csr_matmat(*args, A.values.abs().double(), X.abs().double())
    nnz_i = (A.row_offsets[1:] - A.row_offsets[:-1]).double()[:, None]
    return Y64, (nnz_i + 2) * U * AX, AX


def spmm_vs_plain(kernel, name, csr, seed):
    """K3 or K4 against its plain version (ULP compare, normwise 1e-5)
    and a float64 product (|d|_il <= (nnz_i + 2) u (|A||X|)_il) at each
    L of SPMM_LS; two runs bitwise equal. Returns max |kernel - plain|."""
    from tpusparse_torch.utils.compare import compare_results

    plan, matmat, plain = spmm_kernels()[kernel]
    A = plan(csr, "cuda")
    worst = 0.0
    for L in SPMM_LS:
        X = rand(seed + L, (A.num_cols, L))
        Y1 = matmat(A, X)
        Y2 = matmat(A, X)
        Yp = plain(A, X)
        Y64, bound, AX = row_bound(A, X)
        err = float((Y1 - Yp).abs().max()) if Y1.numel() else 0.0
        amax = float(AX.max()) if AX.numel() else 0.0
        what = f"{kernel} {name} L={L}"
        check(Y1.shape == (A.num_rows, L), f"{what}: shape")
        check(torch.equal(Y1, Y2), f"{what}: two runs bitwise equal")
        check(compare_results(Y1, Yp)[0], f"{what}: ULP compare vs plain")
        check(err <= 1e-5 * amax, f"{what}: normwise bound vs plain")
        check(((Y1.double() - Y64).abs() <= bound).all(),
              f"{what}: row bound vs float64")
        worst = max(worst, err)
    print(f"[2] {kernel} {name} {A.num_rows}x{A.num_cols} nnz {A.nnz} "
          f"L={list(SPMM_LS)}: max|{kernel}-plain| {worst:.3e}, ULP and "
          f"normwise vs plain PASS, row bound vs float64 PASS, bitwise "
          f"repeat PASS")
    return worst


def dia_as_csr(D):
    """The float64 CSR (row offsets, column indices, values) on the card
    of a DIA operand, masked or value planes: the independent float64
    product the DIA kernels are held to."""
    from tpusparse_torch.kernels import dia_stream

    n = D.num_rows
    if isinstance(D, dia_stream.DiaStreamDevice):
        zero = torch.zeros((), dtype=torch.float64, device=D.mask.device)
        planes = torch.stack([
            torch.where(((D.mask >> k) & 1) != 0, D.vals[k].double(), zero)
            for k in range(len(D.offsets))])
    else:
        planes = D.data.double()
    i = torch.arange(n, device=planes.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(D.offsets):
        ok = (i + off >= 0) & (i + off < D.num_cols)
        rows.append(i[ok])
        cols.append(i[ok] + off)
        vals.append(planes[k][ok])
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(r * D.num_cols + c)
    ro = torch.zeros(n + 1, dtype=torch.int64, device=planes.device)
    ro[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return ro, c[order], v[order]


def kd_dia_vs_plain(kernel, name, D, L, seed):
    """K1d or K5d against its plain version, bitwise, and against an
    independent float64 product: |d|_i <= 2 (K + 2) u (|A||x|)_i."""
    from tpusparse_torch.kernels import dia_stream
    from tpusparse_torch.ops.reference import csr_matmat

    XT = rand64(seed, (L, D.num_cols))
    if kernel == "K1d":
        Y = dia_stream.spmm_dia_stream_t(D, XT)
        Yp = dia_stream.spmm_dia_masked_plain(D, XT)
    else:
        Y = dia_stream.spmm_dia_planes_t(D, XT)
        Yp = dia_stream.spmm_dia_planes_plain(D, XT)
    ro, c, v = dia_as_csr(D)
    X = XT.T.contiguous()
    Y64 = csr_matmat(D.num_rows, ro, c, v, X).T
    AX = csr_matmat(D.num_rows, ro, c, v.abs(), X.abs()).T
    bound = 2 * (len(D.offsets) + 2) * U64 * AX
    what = f"{kernel} {name} L={L}"
    check(Y.dtype == torch.float64 and Y.shape == (L, D.num_rows)
          and torch.isfinite(Y).all(), f"{what}: finite float64 Y")
    check(torch.equal(Y, Yp), f"{what}: bitwise equal to plain")
    check(((Y - Y64).abs() <= bound).all(),
          f"{what}: within 2(K+2)u|A||x| of a float64 CSR product")
    print(f"[2] {what}: bitwise equal to plain, max|{kernel}-float64 CSR| "
          f"{float((Y - Y64).abs().max()):.3e} (bound max "
          f"{float(bound.max()):.3e})")
    return float((Y - Yp).abs().max())


def kd_csr_vs_plain(kernel, name, csr, seed):
    """K2d (L = 1), K3d or K4d (L in F64_LS) against its plain version
    and the ``torch.sparse`` float64 product: |d|_il <= 2 (nnz_i + 2) u
    (|A||X|)_il; two runs bitwise equal. Returns max |kernel - plain|."""
    from tpusparse_torch.kernels import ell_spmm, merge_spmv, spmm_merge
    from tpusparse_torch.ops.reference import csr_matmat

    plan, matmat, plain = {
        "K2d": (merge_spmv.to_device_merge,
                lambda A, X: merge_spmv.merge_matvec(A, X[:, 0])[:, None],
                lambda A, X: merge_spmv.spmv_merge_plain(A, X[:, 0])[:,
                                                                     None]),
        "K3d": (merge_spmv.to_device_merge, spmm_merge.merge_matmat,
                spmm_merge.spmm_merge_plain),
        "K4d": (ell_spmm.to_device_row_split, ell_spmm.row_split_matmat,
                ell_spmm.spmm_row_split_plain)}[kernel]
    A = plan(csr, "cuda", torch.float64)
    lib = library_csr(A) if A.nnz else None
    nnz_i = (A.row_offsets[1:] - A.row_offsets[:-1]).double()[:, None]
    worst = 0.0
    for L in ((1,) if kernel == "K2d" else F64_LS):
        X = rand64(seed + L, (A.num_cols, L))
        Y1, Y2, Yp = matmat(A, X), matmat(A, X), plain(A, X)
        AX = csr_matmat(A.num_rows, A.row_offsets, A.col_indices,
                        A.values.abs(), X.abs())
        bound = 2 * (nnz_i + 2) * U64 * AX
        Yl = lib @ X if lib is not None else torch.zeros_like(Y1)
        what = f"{kernel} {name} L={L}"
        check(Y1.dtype == torch.float64 and Y1.shape == (A.num_rows, L),
              f"{what}: float64 Y of shape ({A.num_rows}, {L})")
        check(torch.equal(Y1, Y2), f"{what}: two runs bitwise equal")
        check(((Y1 - Yp).abs() <= bound).all(), f"{what}: bound vs plain")
        check(((Y1 - Yl).abs() <= bound).all(),
              f"{what}: bound vs torch.sparse float64")
        if Y1.numel():
            worst = max(worst, float((Y1 - Yp).abs().max()))
    print(f"[2] {kernel} {name} {A.num_rows}x{A.num_cols} nnz {A.nnz}: "
          f"max|{kernel}-plain| {worst:.3e}, within 2(nnz_i+2)u|A||x| of "
          f"plain and of torch.sparse float64, bitwise repeat PASS")
    return worst


def library_csr(A):
    """The CSR arrays of a plan as a ``torch.sparse`` CSR tensor, for
    the library call timed beside the kernels (cuSPARSE)."""
    return torch.sparse_csr_tensor(A.row_offsets, A.col_indices, A.values,
                                   size=(A.num_rows, A.num_cols))


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


def report(phase, what, t, flops, nbytes, fp64=False):
    """Print one timing line: kernel and plain (per call, device), the
    library call per call, and the bound (against the float64 peak with
    ``fp64``); returns the bound."""
    from tpusparse_torch.bench.models import bound_ms, gflops

    (kev, kdev), (pev, pdev) = t["kernel"], t["plain"]
    bms, by = bound_ms(flops, nbytes, fp64=fp64)
    print(f"[{phase}] {what}: kernel {kev:.4f} ms/call, device {kdev:.4f}"
          f" ms ({gflops(flops, kdev * 1e-3):.1f} GFLOP/s, "
          f"{nbytes / kdev * 1e-6:.1f} GB/s of {nbytes / 1e6:.1f} MB); "
          f"plain {pev:.4f} ms/call, device {pdev:.4f} ms; torch.sparse "
          f"{t['library']:.4f} ms/call; bound {bms:.4f} ms ({by})")
    return bms, by


def slice_spmv(phase, tag, csr, seed):
    """AUTO (must be masked DIA) and merge SpMV through ``spmv``: check
    against float64, time beside the plain versions and the library."""
    from tpusparse_torch import plan_kind, plan_matrix, spmv
    from tpusparse_torch.bench.models import (
        dia_masked_bytes,
        spmm_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import cuda_time_ms
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
    lib = library_csr(M)
    lib_ms = cuda_time_ms(lambda: lib @ x)
    times = {
        "K1": time_pair(lambda: spmv(A, x),
                        lambda: dia_stream.spmm_dia_masked_plain(A.dia, XT)),
        "K2": time_pair(lambda: spmv(M, x),
                        lambda: merge_spmv.spmv_merge_plain(M, x)),
    }
    fl = spmv_flops(csr.nnz)
    n = csr.num_rows
    for k, label, nbytes in (
            ("K1", "auto (masked DIA)", dia_masked_bytes(n)),
            ("K2", "merge", spmm_bytes(csr.nnz, n, csr.num_cols))):
        times[k]["library"] = lib_ms
        times[k]["bound"] = report(phase, f"{tag} spmv {label}", times[k],
                                   fl, nbytes)
    return A, M, times


def slice_spmm(tag, C, plans, seed):
    """``spmm`` at L_MULTI through each (label, plan, kernel, expected
    family) of ``plans`` of one matrix, whose CSR operand on the card is
    ``C``: check against float64, time the call beside the plain
    version, the library call and the bound."""
    from tpusparse_torch import plan_kind, spmm
    from tpusparse_torch.bench.models import (
        dia_masked_bytes,
        spmm_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.kernels import dia_stream

    X = rand(seed, (C.num_cols, L_MULTI))
    Y64, bound, _ = row_bound(C, X)
    lib = library_csr(C)
    lib_ms = cuda_time_ms(lambda: lib @ X)
    fl = spmv_flops(C.nnz, L_MULTI)
    out = {}
    for label, P, kernel, kind in plans:
        check(plan_kind(P) == kind,
              f"{tag} {label}: plan {kind} (got {plan_kind(P)})")
        Y = spmm(P, X)
        check(Y.shape == (C.num_rows, L_MULTI) and torch.isfinite(Y).all(),
              f"{tag} {label}: finite Y of shape ({C.num_rows}, {L_MULTI})")
        check(((Y.double() - Y64).abs() <= bound).all(),
              f"{tag} {label}: Y within (nnz_i+2)u|A||X| of float64")
        if kernel == "K1":
            # the kernel alone on K1's (L, n) layout, and through spmm,
            # which transposes X in and Y out
            XT = X.T.contiguous()
            t = time_pair(lambda: dia_stream.spmm_dia_stream_t(P.dia, XT),
                          lambda: dia_stream.spmm_dia_masked_plain(P.dia,
                                                                   XT))
            nbytes = dia_masked_bytes(C.num_rows, L_MULTI)
            call = (cuda_time_ms(lambda: spmm(P, X)),
                    graph_time_ms(lambda: spmm(P, X)))
            print(f"[6] {tag} spmm {label} through spmm (with the "
                  f"transposes): {call[0]:.4f} ms/call, device "
                  f"{call[1]:.4f} ms")
        else:
            _, _, plain = spmm_kernels()[kernel]
            t = time_pair(lambda: spmm(P, X), lambda: plain(P, X))
            nbytes = spmm_bytes(C.nnz, C.num_rows, C.num_cols, L_MULTI)
        t["library"] = lib_ms
        t["bound"] = report(6, f"{tag} spmm {label} ({kernel}) L={L_MULTI}",
                            t, fl, nbytes)
        out[kernel] = t
    return out


def slice_var_spmv(tag, csr, seed):
    """[8] AUTO (must be float32 value planes: K5) and ``plan_dia_bf16``
    (bf16 planes) on a variable-coefficient band: ``spmv`` checked
    against float64 and timed beside the plain version, the library call
    and the bound. Returns (AUTO plan, bf16 plan, timings by plane type)."""
    from tpusparse_torch import plan_dia_bf16, plan_kind, plan_matrix, spmv
    from tpusparse_torch.bench.models import dia_planes_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.formats.dia import DiaDevice
    from tpusparse_torch.kernels import dia_stream

    A32 = plan_matrix(csr, "auto", device="cuda")
    check(plan_kind(A32) == "dia" and isinstance(A32.dia, DiaDevice),
          f"{tag}: AUTO gives value planes (got {plan_kind(A32)})")
    A16 = plan_dia_bf16(csr, device="cuda")
    check(plan_kind(A16) == "dia_bf16"
          and A16.dia.data.dtype == torch.bfloat16,
          f"{tag}: plan_dia_bf16 gives bf16 planes (got {plan_kind(A16)})")
    n, K = csr.num_rows, len(A32.dia.offsets)
    x = rand(seed, csr.num_cols)
    XT = x.reshape(1, -1)
    times = {}
    for label, P, plane_bytes in (("f32", A32, 4), ("bf16", A16, 2)):
        y = spmv(P, x)
        Y64 = dia_stream.spmm_dia_planes_plain(P.dia, XT.double())[0]
        AX = dia_stream.spmm_dia_planes_plain(
            dataclasses.replace(P.dia, data=P.dia.data.abs()),
            XT.abs().double())[0]
        check(torch.isfinite(y).all() and y.shape == (n,),
              f"{tag} {label}: finite y of shape ({n},)")
        check(((y.double() - Y64).abs() <= 2 * K * U * AX).all(),
              f"{tag} {label}: y within 2Ku|A||x| of float64 on its planes")
        times[label] = time_pair(
            lambda: spmv(P, x),
            lambda: dia_stream.spmm_dia_planes_plain(P.dia, XT))
    C = csr.to("cuda")
    lib = library_csr(C)
    lib_ms = cuda_time_ms(lambda: lib @ x)
    y16, y32 = spmv(A16, x), spmv(A32, x)
    rel = float((y16 - y32).abs().max() / y32.abs().max())
    print(f"[8] {tag}: {n} rows, {csr.nnz} nnz, {K} planes; bf16-plane "
          f"operator's relative deviation {rel:.3e}")
    check(rel < 3e-2, f"{tag}: bf16-plane deviation {rel} below 3e-2")
    for label, plane_bytes in (("f32", 4), ("bf16", 2)):
        t = times[label]
        t["library"] = lib_ms
        t["bound"] = report(8, f"{tag} spmv {label} planes (K5)", t,
                            spmv_flops(csr.nnz),
                            dia_planes_bytes(n, n, K, 1, plane_bytes))
    del C, lib
    return A32, A16, times


def run_solve(phase, tag, solve, csr, b, tol=CG_TOL,
              true_max=TRUE_RESIDUAL_MAX):
    """Run ``solve()`` twice (the first solve pays one-time costs: module
    loads, allocator growth); checks and times the second against the
    float64 CSR ``csr``: converged to ``tol``, float64 true residual
    below ``true_max``. Returns (iterations, ms/iteration, float64 true
    residual); a refinement solve counts its inner iterations and has
    converged when its exact residual is below the tolerance."""
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    first, ms = walls
    A64 = csr.to_scipy().astype(np.float64)
    b64 = b.double().cpu().numpy()
    x64 = res.x.double().cpu().numpy()
    true_res = float(np.linalg.norm(b64 - A64 @ x64) / np.linalg.norm(b64))
    iters = getattr(res, "iterations", getattr(res, "inner_iterations", 0))
    residual = float(res.residual)
    converged = getattr(res, "converged", residual < tol)
    check(converged, f"{tag}: converged")
    check(np.isfinite(x64).all(), f"{tag}: finite x")
    check(true_res < true_max, f"{tag}: true residual {true_res}")
    per = ms / max(iters, 1)
    extra = "".join(f", {k} {getattr(res, k)}" for k in
                    ("replacements", "restarts", "refinements")
                    if hasattr(res, k))
    print(f"[{phase}] {tag}: {iters} iterations{extra}, converged, "
          f"residual {residual:.3e}, float64 true residual "
          f"{true_res:.3e}, {ms:.1f} ms ({per:.4f} ms/iteration; first "
          f"solve {first:.1f} ms)")
    return iters, per, true_res


def run_cg(tag, A, csr, b, phase=4):
    """CG at tol 1e-5 through ``cg_solve`` (``run_solve``)."""
    from tpusparse_torch import cg_solve

    return run_solve(phase, f"cg {tag}", lambda: cg_solve(
        A, b, max_iters=10000, tolerance=CG_TOL), csr, b)


def run_cg_multi(tag, A, C, B, phase=7):
    """``cg_solve_multi`` at tol 1e-5, twice (the second timed), on the
    plan ``A`` of the CSR operand ``C`` (on the card); every lane must
    converge with a float64 true residual < 1e-4. Returns (iterations,
    ms/iteration, largest true residual)."""
    from tpusparse_torch import cg_solve_multi
    from tpusparse_torch.ops.reference import csr_matmat

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve_multi(A, B, max_iters=10000, tolerance=CG_TOL)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    first, ms = walls
    X64, B64 = res.x.double(), B.double()
    R64 = B64 - csr_matmat(C.num_rows, C.row_offsets, C.col_indices,
                           C.values.double(), X64)
    true_res = (torch.linalg.norm(R64, dim=0)
                / torch.linalg.norm(B64, dim=0)).cpu().numpy()
    check(res.x.shape == B.shape and torch.isfinite(res.x).all(),
          f"{tag}: finite X of B's shape")
    check(bool(res.converged.all()), f"{tag}: every lane converged")
    check((true_res < TRUE_RESIDUAL_MAX).all(),
          f"{tag}: true residuals {true_res}")
    per = ms / max(res.iterations, 1)
    print(f"[{phase}] cg_multi {tag} L={B.shape[1]}: {res.iterations} "
          f"iterations, "
          f"all {B.shape[1]} lanes converged, residual max "
          f"{float(res.residual.max()):.3e}, float64 true residual max "
          f"{true_res.max():.3e}, {ms:.1f} ms ({per:.4f} ms/iteration; "
          f"first solve {first:.1f} ms)")
    return res.iterations, per, float(true_res.max())


def slice_fp64_spmv(tag, csr, strategy, kernel, seed):
    """[10] ``spmv`` on a float64 plan: the plan runs ``kernel`` (K1d,
    K2d or K5d), y is within 2(nnz_i + 2)u|A||x| of the float64
    ``reference`` plan's product, and the call is timed beside the plain
    version, ``torch.sparse`` in float64 and the float64 bound. Returns
    (plan, timings)."""
    from tpusparse_torch import plan_matrix, plan_semantics, spmv
    from tpusparse_torch.bench.models import (
        dia_masked_bytes,
        dia_planes_bytes,
        spmm_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.formats.dia import DiaDevice
    from tpusparse_torch.kernels import dia_stream, merge_spmv
    from tpusparse_torch.ops.reference import csr_matvec

    A = plan_matrix(csr, strategy, dtype=np.float64, device="cuda")
    n = csr.num_rows
    if kernel == "K1d":
        ok = isinstance(A.dia, dia_stream.DiaStreamDevice) and A.rest is None
        plain = dia_stream.spmm_dia_masked_plain
        nbytes = dia_masked_bytes(n, 1, 8)
    elif kernel == "K5d":
        ok = isinstance(A.dia, DiaDevice) and A.rest is None
        plain = dia_stream.spmm_dia_planes_plain
        nbytes = dia_planes_bytes(n, csr.num_cols, len(A.dia.offsets), 1, 8,
                                  8)
    else:
        ok = isinstance(A, merge_spmv.MergeDevice)
        nbytes = spmm_bytes(csr.nnz, n, csr.num_cols, 1, 8)
    check(ok and plan_semantics(A) == "ieee-f64",
          f"{tag} {strategy} float64: plans {kernel}")
    C = plan_matrix(csr, "reference", dtype=np.float64, device="cuda")
    x = rand64(seed, csr.num_cols)
    y = spmv(A, x)
    args = (C.num_rows, C.row_offsets, C.col_indices)
    y64 = spmv(C, x)
    ax = csr_matvec(*args, C.values.abs(), x.abs())
    nnz_i = (C.row_offsets[1:] - C.row_offsets[:-1]).double()
    check(y.dtype == torch.float64 and y.shape == (n,)
          and torch.isfinite(y).all(), f"{tag}: finite float64 y")
    check(((y - y64).abs() <= 2 * (nnz_i + 2) * U64 * ax).all(),
          f"{tag}: y within 2(nnz_i+2)u|A||x| of the reference plan")
    XT = x.reshape(1, -1)
    if kernel == "K2d":
        t = time_pair(lambda: spmv(A, x),
                      lambda: merge_spmv.spmv_merge_plain(A, x))
    else:
        t = time_pair(lambda: spmv(A, x), lambda: plain(A.dia, XT))
    lib = library_csr(C)
    t["library"] = cuda_time_ms(lambda: lib @ x)
    t["bound"] = report(10, f"{tag} spmv float64 {strategy} ({kernel})", t,
                        spmv_flops(csr.nnz), nbytes, fp64=True)
    return A, t


def slice_fp64_spmm(tag, C, plans, seed):
    """[11] ``spmm`` at L_MULTI through each (label, plan, kernel) of
    ``plans`` of one matrix, whose float64 CSR on the card is ``C``:
    within 2(nnz_i + 2)u|A||X| of its float64 product, timed beside the
    plain version, ``torch.sparse`` in float64 and the float64 bound (K1d
    alone on (L, n) for a masked plan)."""
    from tpusparse_torch import spmm
    from tpusparse_torch.bench.models import (
        dia_masked_bytes,
        spmm_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.kernels import dia_stream, ell_spmm, spmm_merge
    from tpusparse_torch.ops.reference import csr_matmat

    X = rand64(seed, (C.num_cols, L_MULTI))
    args = (C.num_rows, C.row_offsets, C.col_indices)
    Y64 = csr_matmat(*args, C.values, X)
    AX = csr_matmat(*args, C.values.abs(), X.abs())
    nnz_i = (C.row_offsets[1:] - C.row_offsets[:-1]).double()[:, None]
    lib = library_csr(C)
    lib_ms = cuda_time_ms(lambda: lib @ X)
    fl = spmv_flops(C.nnz, L_MULTI)
    out = {}
    for label, P, kernel in plans:
        Y = spmm(P, X)
        check(Y.dtype == torch.float64 and Y.shape == (C.num_rows, L_MULTI)
              and torch.isfinite(Y).all(), f"{tag} {label}: finite Y")
        check(((Y - Y64).abs() <= 2 * (nnz_i + 2) * U64 * AX).all(),
              f"{tag} {label}: Y within 2(nnz_i+2)u|A||X| of float64")
        if kernel == "K1d":
            XT = X.T.contiguous()
            t = time_pair(lambda: dia_stream.spmm_dia_stream_t(P.dia, XT),
                          lambda: dia_stream.spmm_dia_masked_plain(P.dia,
                                                                   XT))
            nbytes = dia_masked_bytes(C.num_rows, L_MULTI, 8)
            call = (cuda_time_ms(lambda: spmm(P, X)),
                    graph_time_ms(lambda: spmm(P, X)))
            print(f"[11] {tag} spmm {label} through spmm (with the "
                  f"transposes): {call[0]:.4f} ms/call, device "
                  f"{call[1]:.4f} ms")
        else:
            plain = (spmm_merge.spmm_merge_plain if kernel == "K3d"
                     else ell_spmm.spmm_row_split_plain)
            t = time_pair(lambda: spmm(P, X), lambda: plain(P, X))
            nbytes = spmm_bytes(C.nnz, C.num_rows, C.num_cols, L_MULTI, 8)
        t["library"] = lib_ms
        t["bound"] = report(11, f"{tag} spmm float64 {label} ({kernel}) "
                            f"L={L_MULTI}", t, fl, nbytes, fp64=True)
        out[kernel] = t
    return out


def run_refined_multi(tag, A32, A64, C64, B):
    """[11] ``cg_solve_multi_refined`` to REFINE_TOL, twice (the second
    timed): every lane's float64 true residual on the float64 CSR ``C64``
    below REFINE_TRUE_MAX."""
    from tpusparse_torch import cg_solve_multi_refined
    from tpusparse_torch.ops.reference import csr_matmat

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve_multi_refined(A32, A64, B, tolerance=REFINE_TOL)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    first, ms = walls
    R = B - csr_matmat(C64.num_rows, C64.row_offsets, C64.col_indices,
                       C64.values, res.x)
    true_res = (torch.linalg.norm(R, dim=0)
                / torch.linalg.norm(B, dim=0)).cpu().numpy()
    check(res.x.dtype == torch.float64 and res.x.shape == B.shape
          and torch.isfinite(res.x).all(), f"{tag}: finite float64 X")
    check(float(res.residual.max()) < REFINE_TOL,
          f"{tag}: every lane below {REFINE_TOL}")
    check((true_res < REFINE_TRUE_MAX).all(),
          f"{tag}: float64 true residuals {true_res}")
    print(f"[11] cg_multi_refined {tag} L={B.shape[1]}: {res.refinements} "
          f"refinements, {res.inner_iterations} inner iterations, residual "
          f"max {float(res.residual.max()):.3e}, float64 true residual max "
          f"{true_res.max():.3e}, {ms:.1f} ms (first solve {first:.1f} ms)")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from tpusparse_torch import CsrMatrix, plan_kind, plan_matrix
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.io.market import read_market
    from tpusparse_torch.kernels import (
        _build,
        dia_stream,
        ell_spmm,
        merge_spmv,
        spmm_merge,
    )
    from tpusparse_torch.ops.reference import csr_matmat

    t_start = time.perf_counter()
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
    k1_err = max(k1_vs_plain("lap3d-48", D48, L, 10 + L) for L in (1, 4, 16))
    fixtures = [("lap3d-48", lap48),
                ("rmat-18-ef16", gen.make_rmat(18, edge_factor=16).to_csr()),
                ("wheel-100000", gen.make_wheel(100000).to_csr())]
    fixtures += [(p.stem, read_market(p).to_csr())
                 for p in sorted((ROOT / "data" / "real").glob("*.mtx"))]
    fixtures += [
        ("empty-rows", CsrMatrix(6, 5, np.array([0, 0, 2, 2, 2, 3, 3]),
                                 np.array([1, 4, 0]),
                                 np.array([1.0, 2.0, 3.0]))),
        ("nnz-0", CsrMatrix(4, 4, np.zeros(5, np.int32),
                            np.zeros(0, np.int32), np.zeros(0)))]
    k2_err = max(k2_vs_plain(name, csr, 20 + i)
                 for i, (name, csr) in enumerate(fixtures))
    k3_err = max(spmm_vs_plain("K3", name, csr, 40 + i)
                 for i, (name, csr) in enumerate(fixtures))
    k4_err = max(spmm_vs_plain("K4", name, csr, 60 + i)
                 for i, (name, csr) in enumerate(fixtures))
    rmat18 = fixtures[1][1]
    k5_err = max(
        k5_vs_plain(name, dia_planes_of(csr, pd), L, 80 + L)
        for name, csr in plane_fixtures(gen, read_market)
        for pd in (torch.float32, torch.bfloat16) for L in (1, 4, 16))
    # the float64 twins on the same fixtures
    D48d = plan_matrix(lap48, "auto", dtype=np.float64, device="cuda").dia
    err64 = {"K1d": max(kd_dia_vs_plain("K1d", "lap3d-48", D48d, L, 90 + L)
                        for L in F64_LS)}
    for kernel, seed in (("K2d", 100), ("K3d", 120), ("K4d", 140)):
        err64[kernel] = max(kd_csr_vs_plain(kernel, name, csr, seed + i)
                            for i, (name, csr) in enumerate(fixtures))
    err64["K5d"] = max(
        kd_dia_vs_plain("K5d", name, dia_planes_of(csr, torch.float64), L,
                        160 + L)
        for name, csr in plane_fixtures(gen, read_market) for L in F64_LS)
    torch.cuda.synchronize()
    print(f"[2] done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # [3]-[4] the single-RHS path; count launches from here on
    counters = {"K1": (dia_stream, "LAUNCHES"), "K2": (merge_spmv, "LAUNCHES"),
                "K3": (spmm_merge, "LAUNCHES"), "K4": (ell_spmm, "LAUNCHES"),
                "K5": (dia_stream, "PLANES_LAUNCHES"),
                "K1d": (dia_stream, "LAUNCHES_F64"),
                "K2d": (merge_spmv, "LAUNCHES_F64"),
                "K3d": (spmm_merge, "LAUNCHES_F64"),
                "K4d": (ell_spmm, "LAUNCHES_F64"),
                "K5d": (dia_stream, "PLANES_LAUNCHES_F64")}

    def reset_counts():
        for m, attr in counters.values():
            setattr(m, attr, 0)

    def read_counts(what, must):
        torch.cuda.synchronize()
        counts = {k: getattr(m, attr) for k, (m, attr) in counters.items()}
        print(f"[5] {what} launches: {counts}", flush=True)
        check(all(counts[k] > 0 for k in must),
              f"{', '.join(must)} launched on the {what}")
        return counts

    reset_counts()
    slice_spmv(3, "lap3d-48", lap48, 30)
    lap160 = gen.make_laplacian_grid3d(160).to_csr()
    A160, M160, t160 = slice_spmv(4, "lap3d-160", lap160, 31)
    x_true = np.random.default_rng(32).standard_normal(lap160.num_cols)
    b = torch.from_numpy((lap160.to_scipy() @ x_true).astype(np.float32))
    run_cg("lap3d-160 auto (K1)", A160, lap160, b.cuda())
    rmat_spd17 = gen.make_rmat_spd(17, edge_factor=4).to_csr()
    gr = read_market(ROOT / "data/real/gr_30_30.mtx").to_csr()
    for tag, csr in (("rmat_spd-17-ef4 merge (K2)", rmat_spd17),
                     ("gr_30_30 merge (K2)", gr)):
        b = rand(33, csr.num_rows)
        run_cg(tag, plan_matrix(csr, "merge", device="cuda"), csr, b)
    path1 = read_counts("single-RHS path", ("K1", "K2"))

    # [6]-[7] the multi-RHS path, counted from 0 again
    reset_counts()
    del A160, M160
    A16 = plan_matrix(lap160, "auto", L=L_MULTI, device="cuda")
    M16 = plan_matrix(lap160, "merge", L=L_MULTI, device="cuda")
    t6 = slice_spmm("lap3d-160", M16, (
        ("auto", A16, "K1", "dia"), ("merge", M16, "K3", "merge"),
        ("row_split", plan_matrix(lap160, "row_split", L=L_MULTI,
                                  device="cuda"), "K4", "row_split")), 34)
    Mr = plan_matrix(rmat18, "auto", L=L_MULTI, device="cuda")
    slice_spmm("rmat-18-ef16", Mr, (
        ("auto", Mr, "K3", "merge"),
        ("row_split", plan_matrix(rmat18, "row_split", L=L_MULTI,
                                  device="cuda"), "K4", "row_split")), 35)
    del Mr
    X_true = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (lap160.num_cols, L_MULTI))).cuda()
    B160 = csr_matmat(M16.num_rows, M16.row_offsets, M16.col_indices,
                      M16.values.double(), X_true).float()
    run_cg_multi("lap3d-160 auto (K1, (L, n) state)", A16, M16, B160)
    R17 = plan_matrix(rmat_spd17, "auto", L=L_MULTI, device="cuda")
    check(isinstance(R17, merge_spmv.MergeDevice),
          "rmat_spd-17-ef4 AUTO at L=16 plans merge")
    run_cg_multi("rmat_spd-17-ef4 auto (K3)", R17, R17,
                 rand(37, (rmat_spd17.num_rows, L_MULTI)))
    G = plan_matrix(gr, "row_split", L=L_MULTI, device="cuda")
    run_cg_multi("gr_30_30 row_split (K4)", G, G,
                 rand(38, (gr.num_rows, L_MULTI)))
    path2 = read_counts("multi-RHS path", ("K1", "K3", "K4"))
    del A16, M16, B160, X_true, R17, G
    torch.cuda.empty_cache()

    # [8] variable-coefficient operators, one right-hand side, counted
    # from 0 again
    from tpusparse_torch import (
        cg_solve_bf16,
        cg_solve_multi,
        cg_solve_refined_f32,
        spmm,
    )
    from tpusparse_torch.bench.models import dia_planes_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms

    var7 = gen.make_variable_stencil(160, dims=3, shift=1.0,
                                     seed=0).to_csr()
    var27 = gen.make_variable_stencil(128, dims=3, full=True, shift=1.0,
                                      seed=2).to_csr()
    print(f"[8] var-7-160 and var-27-128 built at "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    reset_counts()
    V7, _, t8_7 = slice_var_spmv("var-7-160", var7, 40)
    V27, V27b, t8_27 = slice_var_spmv("var-27-128", var27, 41)
    b7 = torch.from_numpy((var7.to_scipy() @ np.random.default_rng(
        42).standard_normal(var7.num_cols)).astype(np.float32)).cuda()
    run_cg("var-7-160 auto (K5)", V7, var7, b7, phase=8)
    b27 = torch.from_numpy((var27.to_scipy() @ np.random.default_rng(
        43).standard_normal(var27.num_cols)).astype(np.float32)).cuda()
    it32 = run_cg("var-27-128 auto (K5)", V27, var27, b27, phase=8)[0]
    it16 = run_solve(8, "cg_bf16 var-27-128 (K5 bf16, f32 replacements)",
                     lambda: cg_solve_bf16(V27b, V27, b27,
                                           tolerance=CG_TOL),
                     var27, b27)[0]
    itr = run_solve(8, "cg_refined_f32 var-27-128 (K5 bf16 inner)",
                    lambda: cg_solve_refined_f32(V27b, V27, b27,
                                                 tolerance=CG_TOL),
                    var27, b27)[0]
    print(f"[8] var-27-128 iterations: cg_solve {it32}, cg_solve_bf16 "
          f"{it16}, cg_solve_refined_f32 {itr} (inner)")
    path3 = read_counts("variable-coefficient single-RHS path", ("K5",))
    del V27, V27b, b27, var27
    torch.cuda.empty_cache()

    # [9] variable-coefficient operators at L = 16, counted from 0 again
    reset_counts()
    W = plan_matrix(var7, "auto", L=L_MULTI, device="cuda")
    check(plan_kind(W) == "dia" and W.rest is None
          and not isinstance(W.dia, dia_stream.DiaStreamDevice),
          "var-7-160 AUTO at L=16 plans value planes")
    C7 = var7.to("cuda")
    X = rand(44, (var7.num_cols, L_MULTI))
    Y = spmm(W, X)
    Y64, _, AX = row_bound(C7, X)
    K7 = len(W.dia.offsets)
    check(Y.shape == (var7.num_rows, L_MULTI) and torch.isfinite(Y).all(),
          "var-7-160 spmm: finite Y")
    check(((Y.double() - Y64).abs() <= 2 * K7 * U * AX).all(),
          "var-7-160 spmm: Y within 2Ku|A||X| of float64")
    XT = X.T.contiguous()
    t9 = time_pair(lambda: dia_stream.spmm_dia_planes_t(W.dia, XT),
                   lambda: dia_stream.spmm_dia_planes_plain(W.dia, XT))
    lib = library_csr(C7)
    t9["library"] = cuda_time_ms(lambda: lib @ X)
    del lib
    t9["bound"] = report(9, f"var-7-160 K5 alone on (L, n) L={L_MULTI}", t9,
                         spmv_flops(var7.nnz, L_MULTI),
                         dia_planes_bytes(var7.num_rows, var7.num_cols, K7,
                                          L_MULTI))
    call = (cuda_time_ms(lambda: spmm(W, X)), graph_time_ms(lambda: spmm(W, X)))
    print(f"[9] var-7-160 spmm auto through spmm (with the transposes): "
          f"{call[0]:.4f} ms/call, device {call[1]:.4f} ms")
    X_true = torch.from_numpy(np.random.default_rng(45).standard_normal(
        (var7.num_cols, L_MULTI))).cuda()
    B7 = csr_matmat(C7.num_rows, C7.row_offsets, C7.col_indices,
                    C7.values.double(), X_true).float()
    run_cg_multi("var-7-160 auto (K5, (L, n) state)", W, C7, B7, phase=9)
    path4 = read_counts("variable-coefficient multi-RHS path", ("K5",))
    del W, C7, X, Y, Y64, AX, XT, X_true, B7, V7, b7
    torch.cuda.empty_cache()

    # [10] float64, one right-hand side, counted from 0 again
    from tpusparse_torch import cg_solve, cg_solve_refined

    reset_counts()
    L64, t10_k1 = slice_fp64_spmv("lap3d-160", lap160, "auto", "K1d", 50)
    b64 = torch.from_numpy(lap160.to_scipy() @ np.random.default_rng(
        51).standard_normal(lap160.num_cols)).cuda()
    run_solve(10, "cg float64 lap3d-160 auto (K1d)",
              lambda: cg_solve(L64, b64, max_iters=10000,
                               tolerance=CG64_TOL),
              lap160, b64, CG64_TOL, CG64_TRUE_MAX)
    L32 = plan_matrix(lap160, "auto", device="cuda")
    run_solve(10, "cg_refined lap3d-160 (K1 inner, K1d residuals)",
              lambda: cg_solve_refined(L32, L64, b64), lap160, b64,
              REFINE_TOL, REFINE_TRUE_MAX)
    del L32, L64, b64
    V64, t10_k5 = slice_fp64_spmv("var-7-160", var7, "auto", "K5d", 52)
    b7 = torch.from_numpy(var7.to_scipy() @ np.random.default_rng(
        53).standard_normal(var7.num_cols)).cuda()
    V32 = plan_matrix(var7, "auto", device="cuda")
    run_solve(10, "cg_refined var-7-160 (K5 inner, K5d residuals)",
              lambda: cg_solve_refined(V32, V64, b7), var7, b7, REFINE_TOL,
              REFINE_TRUE_MAX)
    del V32, V64, b7
    _, t10_k2 = slice_fp64_spmv("rmat-18-ef16", rmat18, "merge", "K2d", 54)
    R64 = plan_matrix(rmat_spd17, "auto", dtype=np.float64, device="cuda")
    check(isinstance(R64, merge_spmv.MergeDevice),
          "rmat_spd-17-ef4 AUTO float64 plans merge (K2d)")
    b17 = rand64(55, rmat_spd17.num_rows)
    run_solve(10, "cg float64 rmat_spd-17-ef4 auto (K2d)",
              lambda: cg_solve(R64, b17, max_iters=10000,
                               tolerance=CG64_TOL),
              rmat_spd17, b17, CG64_TOL, CG64_TRUE_MAX)
    R32 = plan_matrix(rmat_spd17, "auto", device="cuda")
    run_solve(10, "cg_refined rmat_spd-17-ef4 (K2 inner, K2d residuals)",
              lambda: cg_solve_refined(R32, R64, b17), rmat_spd17, b17,
              REFINE_TOL, REFINE_TRUE_MAX)
    del R32, R64, b17
    path5 = read_counts("float64 single-RHS path", ("K1d", "K2d", "K5d"))
    torch.cuda.empty_cache()

    # [11] float64 at L = 16, counted from 0 again
    reset_counts()
    C64 = plan_matrix(lap160, "reference", dtype=np.float64, device="cuda")
    M64 = plan_matrix(lap160, "auto", dtype=np.float64, L=L_MULTI,
                      device="cuda")
    check(plan_kind(M64) == "dia" and M64.rest is None and isinstance(
        M64.dia, dia_stream.DiaStreamDevice), "lap3d-160 AUTO float64 at "
          "L=16 plans K1d")
    t11_k1 = slice_fp64_spmm("lap3d-160", C64, (("auto", M64, "K1d"),),
                             56)["K1d"]
    X_true = rand64(57, (lap160.num_cols, L_MULTI))
    B64 = csr_matmat(C64.num_rows, C64.row_offsets, C64.col_indices,
                     C64.values, X_true)
    M32 = plan_matrix(lap160, "auto", L=L_MULTI, device="cuda")
    run_refined_multi("lap3d-160 (K1 inner, K1d residuals)", M32, M64, C64,
                      B64)
    del C64, M64, M32, X_true, B64
    torch.cuda.empty_cache()
    Cr = plan_matrix(rmat18, "reference", dtype=np.float64, device="cuda")
    t11 = slice_fp64_spmm("rmat-18-ef16", Cr, (
        ("merge", plan_matrix(rmat18, "merge", dtype=np.float64, L=L_MULTI,
                              device="cuda"), "K3d"),
        ("row_split", plan_matrix(rmat18, "row_split", dtype=np.float64,
                                  L=L_MULTI, device="cuda"), "K4d")), 58)
    del Cr
    path6 = read_counts("float64 multi-RHS path", ("K1d", "K3d", "K4d"))
    paths = (path1, path2, path3, path4, path5, path6)
    print("[5] main-path launches: " + ", ".join(
        f"{k} {sum(p[k] for p in paths)}" for k in counters))

    def entry(name, source, replaces, key, err, t, fixture):
        return {"name": name, "route": "cuda",
                "source": f"tpusparse_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(p[key] for p in paths), "max_abs_err": err,
                "ms": t["kernel"][1], "plain_ms": t["plain"][1],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library"], "fixture": fixture}

    # K5 replaces B2 and its MXU-rotation body B2', which compute the same y
    b2, b2_mxu = ("tpusparse/kernels/dia_stream.py:739",
                  "tpusparse/kernels/dia_stream.py:904")
    kernels = [
        entry("K1 masked DIA SpMV", "dia_masked.cu",
              "tpusparse/kernels/dia_stream.py:809", "K1", k1_err,
              t160["K1"], "lap3d-160 spmv L=1, device time"),
        entry("K1 masked DIA SpMM", "dia_masked.cu",
              "tpusparse/kernels/dia_stream.py:809", "K1", k1_err,
              t6["K1"], f"lap3d-160 spmm L={L_MULTI} on (L, n), device "
              "time"),
        entry("K2 merge-path CSR SpMV", "merge_spmv.cu",
              "tpusparse/kernels/merge_spmv.py:672", "K2", k2_err,
              t160["K2"], "lap3d-160 spmv L=1, device time"),
        entry("K3 merge-path CSR SpMM", "merge_spmm.cu",
              "tpusparse/kernels/spmm_merge.py:161", "K3", k3_err,
              t6["K3"], f"lap3d-160 spmm L={L_MULTI}, device time"),
        entry("K4 row-split CSR SpMM", "rowsplit_spmm.cu",
              "tpusparse/kernels/ell_spmm.py:132", "K4", k4_err,
              t6["K4"], f"lap3d-160 spmm L={L_MULTI}, device time"),
        entry("K5 value-plane DIA SpMV, f32 planes", "dia_planes.cu", b2,
              "K5", k5_err, t8_7["f32"], "var-7-160 spmv L=1, device time"),
        entry("K5 value-plane DIA SpMV, f32 planes", "dia_planes.cu", b2,
              "K5", k5_err, t8_27["f32"],
              "var-27-128 spmv L=1, device time"),
        entry("K5 value-plane DIA SpMV, bf16 planes", "dia_planes.cu", b2,
              "K5", k5_err, t8_27["bf16"],
              "var-27-128 spmv L=1, device time"),
        entry("K5 value-plane DIA SpMV, bf16 planes", "dia_planes.cu", b2,
              "K5", k5_err, t8_7["bf16"], "var-7-160 spmv L=1, device time"),
        entry("K5 value-plane DIA SpMM, f32 planes", "dia_planes.cu", b2,
              "K5", k5_err, t9, f"var-7-160 spmm L={L_MULTI} on (L, n), "
              "device time"),
        entry("K5 as the port of B2' (MXU-rotation body), f32 planes",
              "dia_planes.cu", b2_mxu, "K5", k5_err, t8_7["f32"],
              "var-7-160 spmv L=1, device time"),
        entry("K1d masked DIA SpMV, float64", "dia_masked.cu",
              "tpusparse/kernels/dia_stream.py:424", "K1d", err64["K1d"],
              t10_k1, "lap3d-160 spmv float64 L=1, device time"),
        entry("K1d masked DIA SpMM, float64", "dia_masked.cu",
              "tpusparse/kernels/dia_stream.py:424", "K1d", err64["K1d"],
              t11_k1, f"lap3d-160 spmm float64 L={L_MULTI} on (L, n), "
              "device time"),
        entry("K2d merge-path CSR SpMV, float64", "merge_spmv.cu",
              "tpusparse/kernels/merge_df.py:287", "K2d", err64["K2d"],
              t10_k2, "rmat-18-ef16 spmv float64 L=1, device time"),
        entry("K3d merge-path CSR SpMM, float64", "merge_spmm.cu",
              "tpusparse/kernels/merge_df.py:495", "K3d", err64["K3d"],
              t11["K3d"], f"rmat-18-ef16 spmm float64 L={L_MULTI}, device "
              "time"),
        entry("K4d row-split CSR SpMM, float64", "rowsplit_spmm.cu",
              "tpusparse/kernels/ell_df.py:186", "K4d", err64["K4d"],
              t11["K4d"], f"rmat-18-ef16 spmm float64 L={L_MULTI}, device "
              "time"),
        entry("K5d value-plane DIA SpMV, float64 planes", "dia_planes.cu",
              "tpusparse/kernels/dia_stream.py:332", "K5d", err64["K5d"],
              t10_k5, "var-7-160 spmv float64 L=1, device time"),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
