#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

Drives the port's two main paths through its hand-written CUDA kernels
and exits non-zero on any failure:

  * one right-hand side: host ingest -> ``plan_matrix(csr, "auto")`` ->
    ``spmv`` / ``cg_solve`` (K1 masked DIA, K2 merge-path SpMV), and
    ``strategy='reference'`` (KR, the reference product);
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
    K4d, and KRd, the float64 reference product);
  * reordering: ``plan_matrix(csr, reorder='auto')`` -> a
    ``ReorderedPlan`` -> ``spmv`` / ``cg_solve`` / ``cg_solve_multi``
    (K6 permutes in and out; K2, K3 on the inner plan);
  * the preconditioned solvers on reordered plans: ``ic0_factorize`` /
    ``spai_inverse`` on the permuted matrix -> ``pcg_solve_multi`` (Jacobi
    and exact IC(0)) / ``spai_cg_solve_multi``, in float32 and float64
    (K6, K3, K3d), and a preconditioner in the caller's order behind K6;
  * the n-major path: ``plan_matrix(csr, 'nmajor', L=16)`` -> ``spmm`` /
    ``cg_solve_multi`` / ``pcg_solve_multi`` on (n, L) blocks (K7), beside
    AUTO (``spmm`` on K7 over the same band, the solvers on K1 in (L, n));
  * the BSR path: ``plan_matrix(csr, 'bsr')`` -> ``spmv`` / ``spmm`` (K8,
    and K8d in float64).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed on its own lines:

  [1] the card (``nvidia-smi`` name and power limit) and the kernels'
      build from ``tpusparse_torch/csrc``;
  [2] every kernel against its plain PyTorch version on the card, under
      the stated error bounds (u = 2^-24): K1 at L = 1, 4 and 16 on
      lap3d-48, bitwise equal to its plain version; K1 and K1d bitwise
      equal to theirs on lap2d-2049 (4,198,401 rows, odd n) at L = 1
      and 16, and at L = 0, 1, 3, 16 and 33 on K1's edge cases (lap2d's
      offsets at odd n, a 32-plane band with bit 31, 32 spaced planes,
      offsets past n, K = 0, n below a row block, n = 0), on XT aligned
      to 16 bytes and one element off; K2,
      and K3 and K4 at L = 1, 3, 16 and 32, on lap3d-48, rmat-18-ef16,
      wheel-100000, ``data/real/*.mtx``, an empty-rows and an nnz = 0
      CSR; two runs of K2, K3 and K4 must be bitwise equal, and K4 equal
      bit for bit to its plain version run on CPU copies of the plan and
      X on every fixture (K4d likewise); K5 with
      float32 and bf16 planes at L = 1, 4 and 16 on var-7-48, var-27-32,
      Trefethen_200, a rectangular band and the DIA part of a hybrid,
      bitwise equal to its plain version and within 2Ku|A||x| of
      float64; the float64 twins at L = 1, 3 and 16 (u = 2^-53): K1d on
      lap3d-48 and K5d on K5's fixtures bitwise equal to their plain
      versions, K2d, K3d and K4d on K2's fixtures within
      2(nnz_i + 2)u|A||x| of theirs and bitwise repeatable, all five
      within that bound of an independent float64 product; K6 bitwise
      equal to ``index_select`` in float32 and float64 at L = 1, 3 and
      16, n = 0, 1, 1023 and 4,096,000, on the identity, a reversal, a
      seeded random permutation and the RCM permutation of scrambled
      lap3d-160; K7 on n-major plans of lap3d-48, lap2d-300 and lap3d-47
      (103,823 rows, not a multiple of 32) at L = 2, 3, 5, 16, 32, 100
      and 128 (lane groups of 2, 1, 1, 4, 4, 4 and 4 values), bitwise
      equal to its plain version and to K1 on X.T; K8 and K8d on
      'bsr' plans of ``make_block_random`` fixtures ((8, 128) blocks,
      full and 0.3 fill, edges cut mid-block with an emptied block row,
      nnz = 0) at L = 1, 3, 16 and 32, within 2(w_i + 2)u|A||X| of their
      plain versions and of a float64 product (w_i the stored entries of
      row i), two runs bitwise equal; KR and KRd (the reference
      product) on K2's fixtures at L = 1, 3 and 16: two calls bitwise
      equal, equal to the CPU's ``index_add_`` bits, and within
      (nnz_i + 2)u|A||X| of the plain version on the card;
  [3] the single-RHS slice at the bench fixture lap3d-48: AUTO must give
      a masked DIA plan; a ``'reference'`` plan (KR) repeats its bits;
      SpMV times (CUDA events per call as made, and
      device time from CUDA-graph replay) beside the plain versions', the
      ``torch.sparse`` CSR product's (the library call, never on the
      path) and the bound (bytes or operations over the H100's peaks,
      ``bench/models.bound_ms``);
  [4] the same at lap3d-160 (4.1M rows, beyond L2), with the
      ``torch.profiler`` split of one merge ``spmv`` (exactly one
      consume and one fix-up launch: no search, no elementwise pass);
      ``spmv`` on the merge plan of rmat-18-ef16 (K2) timed the same
      way, outside the counts; then CG on AUTO (must converge, float64
      true residual < 1e-4) and CG through K2 on rmat_spd(17, 4) and
      gr_30_30, each solved twice and timed on the second solve;
  [6] the multi-RHS slice at L = 16: ``spmm`` at lap3d-160 on AUTO (must
      be a pure masked DIA plan: K1), ``'merge'`` (K3) and
      ``'row_split'`` (K4), and at rmat-18-ef16 on AUTO (must plan
      merge: K3) and ``'row_split'`` (K4); each result checked against a
      float64 product and timed beside its plain version, the library
      call and the bound; K4's result also against its plain version on
      the same X (ULP and normwise on the card, bitwise on CPU copies);
      each row-split plan's work-row table (work rows, split rows and
      chunks) and build time printed; the ``torch.profiler`` split of one
      K3 call at lap3d-160 (exactly one consume and one fix-up launch, as
      in [4]);
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
      with K5 inside; outside the counts, K5d alone at L = 16 timed
      beside its plain version, ``torch.sparse`` and the bound),
      rmat-18-ef16 (``spmv`` on ``'merge'``: K2d, with
      the profiler split of one call as in [4]; lap3d-160 on
      ``'merge'`` timed the same way, outside the counts) and
      rmat_spd-17-ef4 (AUTO must plan merge: ``cg_solve`` on K2d,
      ``cg_solve_refined`` with K2 inside); every refinement must reach
      a float64 true residual < 1e-11; each float64 reference product
      (KRd) repeats its bits;
 [11] float64 at L = 16: ``spmm`` on lap3d-160 AUTO (K1d on (L, n)),
      ``'merge'`` (K3d), ``'row_split'`` (K4d) and ``'reference'``
      (KRd, which must repeat its bits), on rmat-18-ef16
      ``'merge'`` (K3d) and ``'row_split'`` (K4d), K4d's result also
      against its plain version (within 2(nnz_i + 2)u|A||X| on the card,
      bitwise on CPU copies); ``cg_solve_multi_refined`` on lap3d-160 to
      1e-12 on every lane; outside the counts, K3d at L = 1 on the RCM
      inner plan of fem2d-30000 as [13] (c) builds it, against its plain
      version, timed beside it, ``torch.sparse`` and the bound, with the
      profiler split of one call and K2d's ``spmv`` on the same plan;
  [12] the reordered path: lap3d-160 scrambled by a symmetric permutation
      from ``default_rng(5)``; ``reorder='auto'`` must plan RCM;
      ``spmv`` through the ``ReorderedPlan`` against float64, timed
      beside the scrambled matrix's own AUTO plan and ``torch.sparse``;
      K6 alone at L = 1 and 16 beside ``index_select`` and its bound;
      ``cg_solve`` and ``cg_solve_multi`` (L = 16) within one iteration
      of the unscrambled solves of [4] and [7] on the same (permuted)
      right-hand sides; K6 (bitwise) and the inner plan's K2 and K3
      (within 2(nnz_i + 2)u|A||x|) against their plain versions on the
      phase's own operands;
 [13] the preconditioned solvers in the ``cpu_multicg`` layout, with
      ``reorder='auto'`` and tol 1e-5, each given the ``ReorderedPlan``
      (B in and X out through K6) and a preconditioner built from
      ``A.permuted(csr)``: (a) scrambled lap3d-128, float32, L = 16: CG
      and Jacobi IC(0)-PCG, the C++ factorization's time and depth; (b)
      scrambled lap3d-64: SPAI-CG (build time), exact and Jacobi
      IC(0)-PCG (ms per application), CG; (c) ``make_fem2d(30000,
      seed=1)`` in float64, L = 1: CG and Jacobi IC(0)-PCG; every lane
      converged with a float64 true residual < 1e-4. Exact IC(0)-PCG
      there runs ``EXACT_FEM_ITERS`` iterations (the whole solve would
      not fit the time limit; (b) takes it to tol): its ms/iteration,
      and its float64 true residual held to its recurrence's. Every
      kernel of the phase is held against its plain version on the
      phase's own operands: K6 on B, K3 and K3d on the inner plans, the
      Jacobi sweeps' strict triangles and SPAI's M; (a)'s lower strict
      triangle is timed on K3 at L = 16. These preconditioners
      declare the plan's order (``perm=A.perm``); in (b) Jacobi IC(0) of
      the matrix as given also runs in the caller's order, behind K6 (the
      JAX package's call);
 [14] the n-major path at lap3d-160, L = 16: ``spmm`` on
      ``strategy='nmajor'`` (K7) and on AUTO (K7 on the AUTO band),
      checked against float64, each bitwise equal to its plain version
      and K7 to K1 on X.T, timed with K7 and K1 alone beside the
      plain versions, ``torch.sparse`` and the bound; K7 on lap3d-40 at
      L = 3 and 128 bitwise equal to its plain version and to K1 on X.T
      (not counted); ``cg_solve_multi``
      on both plans (iterations within 1, ms/iteration); Jacobi
      IC(0)-PCG at L = 16 on natural-order lap3d-128 on both plans, K7
      and the Jacobi strict triangles' K5 held against their plain
      versions on its operands, and K5 on the lower triangle timed
      alone outside the counts;
 [15] the BSR path: ``make_block_random(8192, 4, seed=0)`` (65,536 x
      1,048,576, 33.5M nnz) with its ``fill_estimate``; ``spmv`` and
      ``spmm`` at L = 1 and 16 on a 'bsr' plan (K8) and its float64 plan
      (K8d), within 2(w_i + 2)u|A||X| of a float64 product and of the
      plain version, timed beside
      the plain version, ``torch.sparse`` CSR, ``torch.sparse_bsr_tensor``
      where PyTorch takes (8, 128) blocks on the card, the bound and K3 on
      the merge plan of the same matrix;
  [5] launch counts of each main path, counted from 0 just before it
      ([3]-[4], [6]-[7], [8], [9], [10], [11], [12], [13], [14] and
      [15]) and read just after: K1, K2 and KR must have run on the
      first, K1, K3 and K4 on the second, K5 on the third and the
      fourth, K1d, K2d and K5d on the fifth, K1d, K3d, K4d and KRd on the
      sixth, K6, K2 and
      K3 on the seventh, K6, K3 and K3d on the eighth, K7 and K1 on the
      ninth, K8 and K8d on the tenth.

The last two lines are a JSON object of the kernels and the result
line ``{"ok": true, "device": {...}}``. The port imports no JAX.
"""

import contextlib
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
    check(torch.equal(Y, Yp), f"K1 {name} L={L}: bitwise equal to plain")
    print(f"[2] K1 {name} L={L}: bitwise equal to plain (bound 2Ku|A||x| "
          f"max {float(bound.max()):.3e})")
    return float(err.max())


def k1_bitwise(what, D, L, seed, shift=0):
    """K1 (a float32 operand) or K1d (float64) on XT (L, n), a view
    ``shift`` elements into its buffer: bitwise equal to its plain
    version. Returns max |kernel - plain| (0)."""
    from tpusparse_torch.kernels import dia_stream

    n = D.num_cols
    buf = torch.empty(L * n + shift, dtype=D.vals.dtype, device="cuda")
    XT = buf[shift:].view(L, n)
    XT.copy_(torch.from_numpy(
        np.random.default_rng(seed).standard_normal((L, n))))
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    Yp = dia_stream.spmm_dia_masked_plain(D, XT)
    what = f"{what} L={L}" + (f", XT {shift} element off 16 B" if shift
                              else "")
    check(Y.shape == (L, D.num_rows) and torch.isfinite(Y).all(),
          f"{what}: finite Y of shape ({L}, {D.num_rows})")
    check(torch.equal(Y, Yp), f"{what}: bitwise equal to plain")
    return float((Y - Yp).abs().max()) if Y.numel() else 0.0


# K1's edge cases: (name, n, offsets), with seeded coefficients and mask
# words (bit 31 set on about half the rows)
K1_EDGE = (("lap2d-2049 offsets, n = 5001", 5001, (-2049, -1, 0, 1, 2049)),
           ("32-plane band", 3000, tuple(range(-16, 16))),
           ("32 spaced planes", 30000,
            tuple(1500 * k - 24000 for k in range(32))),
           ("offsets past n", 700, (-701, -5, 0, 3, 700, 900)),
           ("K = 0", 1500, ()),
           ("n = 300", 300, (-17, -1, 0, 1, 17)),
           ("n = 0", 0, (-1, 0, 1)))


def k1_checks(gen, plan_matrix):
    """[2] K1 and K1d bitwise against their plain versions on lap2d-2049
    at L = 1 and 16 and on ``K1_EDGE`` at L = 0, 1, 3, 16 and 33, XT
    aligned and one element off. Returns {"K1": err, "K1d": err}."""
    from tpusparse_torch.kernels import dia_stream

    lap2049 = gen.make_laplacian_grid2d(2049).to_csr()
    err = {"K1": 0.0, "K1d": 0.0}
    for kernel, dtype in (("K1", np.float32), ("K1d", np.float64)):
        D = plan_matrix(lap2049, "auto", dtype=dtype, device="cuda").dia
        check(isinstance(D, dia_stream.DiaStreamDevice),
              f"lap2d-2049 {kernel}: AUTO plans the masked kernel")
        for L in (1, 16):
            for shift in (0, 1):
                err[kernel] = max(err[kernel], k1_bitwise(
                    f"{kernel} lap2d-2049", D, L, 300 + L, shift))
        print(f"[2] {kernel} lap2d-2049 ({D.num_rows} rows, offsets "
              f"{D.offsets}) L=1, 16: bitwise equal to plain, XT aligned "
              "and one element off", flush=True)
        del D
        for i, (name, n, offsets) in enumerate(K1_EDGE):
            rng = np.random.default_rng(320 + i)
            words = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
            D = dia_stream.from_mask_words(
                n, n, offsets, rng.standard_normal(len(offsets)),
                words.astype(np.uint32), "cuda", dtype)
            for L in (0, 1, 3, 16, 33):
                for shift in (0, 1):
                    err[kernel] = max(err[kernel], k1_bitwise(
                        f"{kernel} {name}", D, L, 340 + L, shift))
        print(f"[2] {kernel} on {len(K1_EDGE)} edge cases ("
              f"{', '.join(c[0] for c in K1_EDGE)}), L = 0, 1, 3, 16, 33: "
              "bitwise equal to plain, XT aligned and one element off",
              flush=True)
    torch.cuda.synchronize()
    return err


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


def kr_checks(fixtures):
    """[2] KR and KRd, the reference product, on K2's fixtures at L = 1,
    3 and 16: two calls bitwise equal, equal to the CPU's ``index_add_``
    bits, and within (nnz_i + 2)u|A||X| of the plain version on the card
    (whose ``index_add_`` adds in no fixed order). Returns the largest
    |KR - plain| and |KRd - plain|."""
    from tpusparse_torch.ops.reference import csr_matmat, csr_matmat_plain

    err = {"KR": 0.0, "KRd": 0.0}
    for name, csr in fixtures:
        for dtype, kernel, u in ((np.float32, "KR", U),
                                 (np.float64, "KRd", U64)):
            H, C = csr.to("cpu", dtype), csr.to("cuda", dtype)
            args = (C.num_rows, C.row_offsets, C.col_indices)
            nnz_i = (C.row_offsets[1:] - C.row_offsets[:-1]).double()
            for L in (1, 3, 16):
                Xh = torch.from_numpy(np.random.default_rng(200 + L)
                                      .standard_normal((csr.num_cols, L))
                                      .astype(dtype))
                X = Xh.cuda()
                Y1 = csr_matmat(*args, C.values, X)
                Y2 = csr_matmat(*args, C.values, X)
                Yh = csr_matmat(H.num_rows, H.row_offsets, H.col_indices,
                                H.values, Xh)
                Yp = csr_matmat_plain(*args, C.values, X)
                AX = csr_matmat_plain(*args, C.values.abs().double(),
                                      X.abs().double())
                what = f"{kernel} {name} L={L}"
                check(torch.equal(Y1, Y2), f"{what}: two calls bitwise "
                      "equal")
                check(torch.equal(Y1.cpu(), Yh), f"{what}: the CPU's bits")
                check(((Y1 - Yp).abs().double()
                       <= (nnz_i[:, None] + 2) * u * AX).all(),
                      f"{what}: within (nnz_i+2)u|A||X| of plain")
                if Y1.numel():
                    err[kernel] = max(err[kernel],
                                      float((Y1 - Yp).abs().max()))
        print(f"[2] KR and KRd {name}: two calls bitwise equal and equal "
              f"to the CPU's bits at L = 1, 3, 16; within (nnz_i+2)u|A||X|"
              f" of the card's index_add_", flush=True)
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


def cpu_copy_equal(plan, plain, csr, dtype, X, Y) -> bool:
    """Whether ``Y`` equals bit for bit the plain version run on the CPU
    on a CPU plan of ``csr`` and a CPU copy of ``X``."""
    return torch.equal(Y.cpu(), plain(plan(csr, "cpu", dtype), X.cpu()))


def row_split_vs_plain(phase, tag, P, csr, X, Y):
    """The Y of a ``row_split`` plan ``P`` of ``csr`` on a main path
    against K4's (K4d's) plain version on the same X: on the card, the
    ULP compare and normwise 1e-5 in float32 or within 2(nnz_i + 2)u|A||X|
    in float64; and bit for bit on CPU copies of the plan and X."""
    from tpusparse_torch.kernels import ell_spmm
    from tpusparse_torch.ops.reference import csr_matmat
    from tpusparse_torch.utils.compare import compare_results

    f64 = Y.dtype == torch.float64
    what = f"{tag} {'K4d' if f64 else 'K4'}"
    with uncounted():
        Yp = ell_spmm.spmm_row_split_plain(P, X)
    err = float((Y - Yp).abs().max())
    AX = csr_matmat(P.num_rows, P.row_offsets, P.col_indices,
                    P.values.abs().double(), X.abs().double())
    if f64:
        nnz_i = (P.row_offsets[1:] - P.row_offsets[:-1]).double()[:, None]
        check(((Y - Yp).abs() <= 2 * (nnz_i + 2) * U64 * AX).all(),
              f"{what}: within 2(nnz_i+2)u|A||X| of plain")
    else:
        check(compare_results(Y, Yp)[0], f"{what}: ULP compare vs plain")
        check(err <= 1e-5 * float(AX.max()),
              f"{what}: normwise bound vs plain")
    t0 = time.perf_counter()
    check(cpu_copy_equal(ell_spmm.to_device_row_split,
                         ell_spmm.spmm_row_split_plain, csr, Y.dtype, X, Y),
          f"{what}: bitwise equal to plain on CPU copies")
    print(f"[{phase}] {what}: max|kernel-plain| on the card {err:.3e}, "
          f"{'2(nnz_i+2)u bound' if f64 else 'ULP and normwise'} vs plain "
          f"PASS, bitwise equal to plain on CPU copies PASS (CPU "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def spmm_vs_plain(kernel, name, csr, seed, cpu_copy=False):
    """K3 or K4 against its plain version (ULP compare, normwise 1e-5)
    and a float64 product (|d|_il <= (nnz_i + 2) u (|A||X|)_il) at each
    L of SPMM_LS; two runs bitwise equal; with ``cpu_copy`` also bitwise
    equal to the plain version on CPU copies. Returns max |kernel -
    plain|."""
    from tpusparse_torch.utils.compare import compare_results

    plan, matmat, plain = spmm_kernels()[kernel]
    A = plan(csr, "cuda")
    worst = cpu_s = 0.0
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
        t0 = time.perf_counter()
        check(not cpu_copy or cpu_copy_equal(plan, plain, csr,
                                             torch.float32, X, Y1),
              f"{what}: bitwise equal to plain on CPU copies")
        cpu_s += time.perf_counter() - t0
        worst = max(worst, err)
    print(f"[2] {kernel} {name} {A.num_rows}x{A.num_cols} nnz {A.nnz} "
          f"L={list(SPMM_LS)}: max|{kernel}-plain| {worst:.3e}, ULP and "
          f"normwise vs plain PASS, row bound vs float64 PASS, bitwise "
          f"repeat PASS" + (f", bitwise equal to plain on CPU copies PASS "
                            f"(CPU {cpu_s:.1f} s)" if cpu_copy else ""))
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


def kd_csr_vs_plain(kernel, name, csr, seed, cpu_copy=False):
    """K2d (L = 1), K3d or K4d (L in F64_LS) against its plain version
    and the ``torch.sparse`` float64 product: |d|_il <= 2 (nnz_i + 2) u
    (|A||X|)_il; two runs bitwise equal; with ``cpu_copy`` also bitwise
    equal to the plain version on CPU copies. Returns max |kernel -
    plain|."""
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
    worst = cpu_s = 0.0
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
        t0 = time.perf_counter()
        check(not cpu_copy or cpu_copy_equal(plan, plain, csr,
                                             torch.float64, X, Y1),
              f"{what}: bitwise equal to plain on CPU copies")
        cpu_s += time.perf_counter() - t0
        if Y1.numel():
            worst = max(worst, float((Y1 - Yp).abs().max()))
    print(f"[2] {kernel} {name} {A.num_rows}x{A.num_cols} nnz {A.nnz}: "
          f"max|{kernel}-plain| {worst:.3e}, within 2(nnz_i+2)u|A||x| of "
          f"plain and of torch.sparse float64, bitwise repeat PASS"
          + (f", bitwise equal to plain on CPU copies PASS (CPU "
             f"{cpu_s:.1f} s)" if cpu_copy else ""))
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
    from tpusparse_torch.ops.reference import csr_matvec, csr_matvec_plain

    A = plan_matrix(csr, "auto", device="cuda", dtype=np.float32)
    check(plan_kind(A) == "dia" and isinstance(A.dia,
                                               dia_stream.DiaStreamDevice),
          f"{tag}: AUTO gives a masked DIA plan (got {plan_kind(A)})")
    M = plan_matrix(csr, "merge", device="cuda", dtype=np.float32)
    R = plan_matrix(csr, "reference", device="cuda", dtype=np.float32)
    x = rand(seed, csr.num_cols)
    args = (M.num_rows, M.row_offsets, M.col_indices)
    y64 = csr_matvec(*args, M.values.double(), x.double())
    ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
    check(torch.equal(spmv(R, x), spmv(R, x)),
          f"{tag} reference (KR): two calls bitwise equal")
    for label, P in (("auto", A), ("merge", M), ("reference", R)):
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
        "KR": time_pair(lambda: spmv(R, x),
                        lambda: csr_matvec_plain(*args, R.values, x)),
    }
    fl = spmv_flops(csr.nnz)
    n = csr.num_rows
    for k, label, nbytes in (
            ("K1", "auto (masked DIA)", dia_masked_bytes(n)),
            ("K2", "merge", spmm_bytes(csr.nnz, n, csr.num_cols)),
            ("KR", "reference", spmm_bytes(csr.nnz, n, csr.num_cols))):
        times[k]["library"] = lib_ms
        times[k]["bound"] = report(phase, f"{tag} spmv {label}", times[k],
                                   fl, nbytes)
    return A, M, times


def row_split_plan(phase, tag, csr, dtype=np.float32):
    """``plan_matrix(csr, 'row_split', L=L_MULTI)`` on the card, with its
    build time and its work-row table printed."""
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.kernels import ell_spmm

    A, ms = timed(lambda: plan_matrix(csr, "row_split", dtype=dtype,
                                      L=L_MULTI, device="cuda"))
    T = A.table
    print(f"[{phase}] {tag} row_split plan ({np.dtype(dtype).name}): "
          f"{T.num_work_rows} work rows, {T.num_split} rows split into "
          f"{T.num_chunks} chunks of C = {ell_spmm.ROW_CHUNK}; built in "
          f"{ms:.1f} ms", flush=True)
    return A


def slice_spmm(tag, csr, C, plans, seed):
    """``spmm`` at L_MULTI through each (label, plan, kernel, expected
    family) of ``plans`` of the host matrix ``csr``, whose CSR operand on
    the card is ``C``: check against float64 (K4 also against its plain
    version), time the call beside the plain version, the library call
    and the bound."""
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
        if kernel == "K4":
            row_split_vs_plain(6, f"{tag} spmm {label}", P, csr, X, Y)
        if kernel == "K1":
            # the kernel alone on K1's (L, n) layout, and through spmm,
            # which runs K7 on the row-major X over the same band
            XT = X.T.contiguous()
            t = time_pair(lambda: dia_stream.spmm_dia_stream_t(P.dia, XT),
                          lambda: dia_stream.spmm_dia_masked_plain(P.dia,
                                                                   XT))
            nbytes = dia_masked_bytes(C.num_rows, L_MULTI)
            call = (cuda_time_ms(lambda: spmm(P, X)),
                    graph_time_ms(lambda: spmm(P, X)))
            print(f"[6] {tag} spmm {label} through spmm (K7 on X as "
                  f"it is): {call[0]:.4f} ms/call, device "
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

    A32 = plan_matrix(csr, "auto", device="cuda", dtype=np.float32)
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
    check(torch.equal(spmv(C, x), y64),
          f"{tag}: the float64 reference product (KRd) repeats its bits")
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


def slice_fp64_spmm(tag, csr, C, plans, seed):
    """[11] ``spmm`` at L_MULTI through each (label, plan, kernel) of
    ``plans`` of the host matrix ``csr``, whose float64 CSR on the card is
    ``C``: within 2(nnz_i + 2)u|A||X| of its float64 product (K4d also
    held to its plain version), timed beside the
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
    from tpusparse_torch.ops.reference import csr_matmat, csr_matmat_plain

    X = rand64(seed, (C.num_cols, L_MULTI))
    args = (C.num_rows, C.row_offsets, C.col_indices)
    Y64 = csr_matmat(*args, C.values, X)
    check(torch.equal(csr_matmat(*args, C.values, X), Y64),
          f"{tag}: the float64 reference product (KRd) repeats its bits")
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
        if kernel == "K4d":
            row_split_vs_plain(11, f"{tag} spmm float64 {label}", P, csr, X,
                               Y)
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
            plain = {"K3d": spmm_merge.spmm_merge_plain,
                     "K4d": ell_spmm.spmm_row_split_plain,
                     "KRd": lambda P, X: csr_matmat_plain(
                         P.num_rows, P.row_offsets, P.col_indices,
                         P.values, X)}[kernel]
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


def scrambled(csr, seed):
    """(``csr`` under a symmetric permutation from ``default_rng(seed)``,
    the permutation): a banded matrix hidden behind a scattered
    pattern."""
    from tpusparse_torch.ops.reorder import permute_symmetric

    p = np.random.default_rng(seed).permutation(csr.num_rows)
    return permute_symmetric(csr, p), p


def bandwidths(csr, A):
    """(bandwidth of ``csr``, bandwidth under the plan's permutation)."""
    from tpusparse_torch.ops.reorder import bandwidth

    return bandwidth(csr), bandwidth(csr, A.perm.cpu().numpy())


# every kernel's label in the launch counts (kernels/_build.LAUNCHES)
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K1d", "K2d", "K3d", "K4d", "K5d",
           "K6", "K7", "K8", "K8d", "KR", "KRd")


def launch_counters():
    """The launch count of every kernel, by label (``_build.LAUNCHES``)."""
    from tpusparse_torch.kernels import _build

    return _build.LAUNCHES


@contextlib.contextmanager
def uncounted():
    """Launches made inside (a kernel held against its plain version, or
    timed alone) leave the main path's launch counts as they were."""
    counters = launch_counters()
    saved = counters.copy()
    try:
        yield
    finally:
        counters.clear()
        counters.update(saved)


def merge_vs_plain(phase, tag, P, X):
    """A merge plan of a main path against its plain version on that
    path's operands: ``spmv`` (K2 or K2d) for a vector X, ``spmm`` (K3 or
    K3d) for an (n, L) block, each within 2(nnz_i + 2)u|A||X| of the
    plain version and of a float64 CSR product (u of the plan's type).
    Not counted."""
    from tpusparse_torch import spmm, spmv
    from tpusparse_torch.kernels import merge_spmv, spmm_merge
    from tpusparse_torch.ops.reference import csr_matmat

    check(isinstance(P, merge_spmv.MergeDevice), f"{tag}: a merge plan")
    fp64 = P.values.dtype == torch.float64
    with uncounted():
        if X.dim() == 1:
            kernel = "K2"
            Y = spmv(P, X)[:, None]
            Yp = merge_spmv.spmv_merge_plain(P, X)[:, None]
            X = X[:, None]
        else:
            kernel = "K3"
            Y, Yp = spmm(P, X), spmm_merge.spmm_merge_plain(P, X)
    kernel += "d" if fp64 else ""
    args = (P.num_rows, P.row_offsets, P.col_indices)
    Y64 = csr_matmat(*args, P.values.double(), X.double())
    AX = csr_matmat(*args, P.values.abs().double(), X.abs().double())
    nnz_i = (P.row_offsets[1:] - P.row_offsets[:-1]).double()[:, None]
    bound = 2 * (nnz_i + 2) * (U64 if fp64 else U) * AX
    what = f"{tag} {kernel} L={X.shape[1]}"
    check(Y.shape == (P.num_rows, X.shape[1]) and Y.dtype == X.dtype
          and torch.isfinite(Y).all(), f"{what}: finite Y of X's type")
    err = (Y - Yp).abs()
    check((err <= bound).all(), f"{what}: within 2(nnz_i+2)u|A||X| of plain")
    check(((Y.double() - Y64).abs() <= bound).all(),
          f"{what}: within 2(nnz_i+2)u|A||X| of a float64 CSR product")
    print(f"[{phase}] {what} ({P.num_rows} rows, {P.nnz} nnz): max|"
          f"{kernel}-plain| {float(err.max()):.3e}, within 2(nnz_i+2)u|A||X|"
          f" of plain and of float64", flush=True)


# the kernels one K2 or K2d call launches: no search, no elementwise pass
K2_KERNELS = ("merge_consume_kernel", "merge_fixup_kernel")


# the kernels one K3 or K3d call launches: no search, no elementwise pass
K3_KERNELS = ("merge_spmm_consume_kernel", "merge_spmm_fixup_kernel")


def fem2d_k3d_times(gen):
    """[11] K3d at L = 1 on the RCM inner plan of ``make_fem2d(30000,
    seed=1)`` in float64, as [13] (c) builds it, outside the launch
    counts: Y within 2(nnz_i + 2)u|A||X| of the plain version and of the
    float64 ``reference`` plan's product, timed beside the plain version,
    ``torch.sparse`` and the bound; the profiler split of one call; K2d's
    ``spmv`` on the same plan timed beside it."""
    from tpusparse_torch import plan_matrix, spmm, spmv
    from tpusparse_torch.bench.models import spmm_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.kernels import merge_spmv, spmm_merge

    tag = "fem2d-30000 RCM inner plan"
    csr = gen.make_fem2d(30000, seed=1).to_csr()
    A = plan_matrix(csr, "auto", dtype=np.float64, reorder="auto", L=1,
                    device="cuda")
    P = A.inner
    check(getattr(A, "order", None) == "rcm"
          and isinstance(P, merge_spmv.MergeDevice),
          f"{tag}: reorder='auto' plans RCM around a merge plan")
    X = rand64(530, (P.num_cols, 1))
    with uncounted():
        merge_vs_plain(11, tag, P, X)
        t = time_pair(lambda: spmm(P, X),
                      lambda: spmm_merge.spmm_merge_plain(P, X))
        lib = library_csr(P)
        t["library"] = cuda_time_ms(lambda: lib @ X)
        x = X[:, 0].contiguous()
        k2d = (cuda_time_ms(lambda: spmv(P, x)),
               graph_time_ms(lambda: spmv(P, x)))
        launch_split(11, f"{tag} spmm float64 L=1 (K3d)",
                     lambda: spmm(P, X), K3_KERNELS)
    t["bound"] = report(11, f"{tag} ({P.num_rows} rows, {P.nnz} nnz) spmm "
                        "float64 merge (K3d) L=1", t, spmv_flops(P.nnz),
                        spmm_bytes(P.nnz, P.num_rows, P.num_cols, 1, 8),
                        fp64=True)
    print(f"[11] {tag} spmv float64 merge (K2d) on the same plan: "
          f"{k2d[0]:.4f} ms/call, device {k2d[1]:.4f} ms", flush=True)
    return t


def k2_spmv_times(tag, csr, seed):
    """[4] ``spmv`` on the merge plan of ``csr`` (K2), outside the launch
    counts: y within (nnz_i + 2)u|A||x| of float64, timed beside the
    plain version, ``torch.sparse`` and the bound."""
    from tpusparse_torch import plan_matrix, spmv
    from tpusparse_torch.bench.models import spmm_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.kernels import merge_spmv
    from tpusparse_torch.ops.reference import csr_matvec

    M = plan_matrix(csr, "merge", device="cuda", dtype=np.float32)
    x = rand(seed, csr.num_cols)
    with uncounted():
        y = spmv(M, x)
        args = (M.num_rows, M.row_offsets, M.col_indices)
        y64 = csr_matvec(*args, M.values.double(), x.double())
        ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
        nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()
        check(torch.isfinite(y).all() and y.shape == (csr.num_rows,),
              f"{tag} merge: finite y of shape ({csr.num_rows},)")
        check(((y.double() - y64).abs() <= (nnz_i + 2) * U * ax).all(),
              f"{tag} merge: y within (nnz_i+2)u|A||x| of float64")
        t = time_pair(lambda: spmv(M, x),
                      lambda: merge_spmv.spmv_merge_plain(M, x))
        lib = library_csr(M)
        t["library"] = cuda_time_ms(lambda: lib @ x)
    t["bound"] = report(4, f"{tag} spmv merge (K2)", t, spmv_flops(csr.nnz),
                        spmm_bytes(csr.nnz, csr.num_rows, csr.num_cols))
    return t


def launch_split(phase, what, fn, expect, calls=20):
    """Print what one call of ``fn`` launches on the card, from
    ``torch.profiler``: launches and device microseconds per call by
    kernel; fail unless it launches a kernel whose name holds each string
    of ``expect`` and no other kernel. Not counted. (Late in a long
    process the profiler may miss some of the events: the launches per
    call it prints can then fall below 1.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with uncounted():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    split = {e.key: (e.count / calls, e.self_device_time_total / calls)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    print(f"[{phase}] {what}, torch.profiler, per call: " + "; ".join(
        f"{k[:70]} x{n:g} {us:.2f} us" for k, (n, us) in split.items()),
          flush=True)
    check(len(split) == len(expect) and all(
        sum(name in k for k in split) == 1 for name in expect),
          f"{what}: a call launches {', '.join(expect)} and nothing else")


def k6_vs_plain(phase, tag, A, B):
    """K6 of a reordered plan on a main path's operand: ``apply_perm``
    and ``apply_inv`` bitwise equal to ``index_select``, and the round
    trip equal to B. Not counted. Returns B in the plan's order."""
    from tpusparse_torch.kernels import permute

    with uncounted():
        Bp = A.apply_perm(B)
        Bq = A.apply_inv(Bp)
    what = f"{tag} K6 {str(B.dtype)[6:]} {tuple(B.shape)}"
    check(torch.equal(Bp, permute.permute_plain(A.perm, B)),
          f"{what}: apply_perm bitwise equal to index_select")
    check(torch.equal(Bq, permute.permute_plain(A.inv_perm, Bp))
          and torch.equal(Bq, B), f"{what}: apply_inv bitwise equal to "
          "index_select, round trip exact")
    print(f"[{phase}] {what}: apply_perm and apply_inv bitwise equal to "
          f"index_select, round trip exact", flush=True)
    return Bp


def randn(seed, shape, dtype):
    """Normal samples made on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def k6_checks(rcm_perm):
    """[2] K6 against its plain version (``index_select``), bitwise, in
    float32 and float64 at L = 1 (a vector), 3 and 16: n = 0, 1 and 1023
    with the identity, a reversal and a seeded random permutation, and
    n = len(rcm_perm) (lap3d-160) with the same three and the RCM
    permutation of scrambled lap3d-160."""
    from tpusparse_torch.kernels import permute

    nb = len(rcm_perm)
    perms = []
    for n in (0, 1, 1023, nb):
        perms += [(n, "identity", np.arange(n)),
                  (n, "reversal", np.arange(n)[::-1].copy()),
                  (n, "random", np.random.default_rng(200 + n).permutation(n))]
    perms.append((nb, "RCM of scrambled lap3d-160", rcm_perm))
    plans = [(n, what, permute.build_permute_plan(p, "cuda"))
             for n, what, p in perms]
    for dtype in (torch.float32, torch.float64):
        for L in (1, 3, 16):
            X = {n: randn(210 + L, (n,) if L == 1 else (n, L), dtype)
                 for n in (0, 1, 1023, nb)}
            for n, what, p in plans:
                Y = permute.permute_apply(p, X[n])
                what = f"K6 n={n} {what} {str(dtype)[6:]} L={L}"
                check(Y.shape == X[n].shape and Y.dtype == dtype,
                      f"{what}: shape and type")
                check(torch.equal(Y, permute.permute_plain(p, X[n])),
                      f"{what}: bitwise equal to index_select")
            del X
    for n, what, _ in plans:
        print(f"[2] K6 n={n} {what}: bitwise equal to index_select in "
              f"float32 and float64 at L = 1, 3 and 16")
    return 0.0


def k6_times(phase, tag, perm, L):
    """K6 alone on the permutation of a reordered plan, float32 X (n,) at
    L = 1 or (n, L): device and per-call times beside the plain version
    (``index_select``, also the one library call that computes it) and
    the byte bound. Not counted."""
    from tpusparse_torch.bench.models import bound_ms, permute_bytes
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.kernels import permute

    n = perm.shape[0]
    X = randn(300 + L, (n,) if L == 1 else (n, L), torch.float32)
    with uncounted():
        check(torch.equal(permute.permute_apply(perm, X),
                          permute.permute_plain(perm, X)),
              f"{tag} K6 L={L}: bitwise equal to index_select")
        t = time_pair(lambda: permute.permute_apply(perm, X),
                      lambda: permute.permute_plain(perm, X))
    t["library"] = cuda_time_ms(lambda: X.index_select(0, perm))
    nbytes = permute_bytes(n, L)
    t["bound"] = bound_ms(0.0, nbytes)
    (kev, kdev), (pev, pdev) = t["kernel"], t["plain"]
    print(f"[{phase}] {tag} K6 L={L}: kernel {kev:.4f} ms/call, device "
          f"{kdev:.4f} ms ({nbytes / kdev * 1e-6:.1f} GB/s of "
          f"{nbytes / 1e6:.1f} MB); plain (index_select) {pev:.4f} ms/call, "
          f"device {pdev:.4f} ms; bound {t['bound'][0]:.4f} ms (bytes)")
    return t


def true_residuals(C, B, X):
    """Per-lane float64 ||B - A X|| / ||B|| on the CSR ``C`` on the card."""
    from tpusparse_torch.ops.reference import csr_matmat

    B64 = B.double()
    R = B64 - csr_matmat(C.num_rows, C.row_offsets, C.col_indices,
                         C.values.double(), X.double())
    return (torch.linalg.norm(R, dim=0) / torch.linalg.norm(B64, dim=0)
            ).cpu().numpy()


def multicg(tag, solver, prep_ms, solve, C, B, twice=True, phase=13):
    """One solver of the ``cpu_multicg`` comparison: ``solve()`` returns
    (result, X in the original order); run twice (the second timed) or
    once; every lane converged with a float64 true residual < 1e-4 on
    ``C``. Prints iterations, set-up and solve times and ms/iteration;
    returns (iterations, ms/iteration, largest true residual)."""
    walls = []
    for _ in range(2 if twice else 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, X = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = walls[-1]
    tr = true_residuals(C, B, X)
    check(X.shape == B.shape and torch.isfinite(X).all(),
          f"{tag} {solver}: finite X of B's shape")
    check(bool(res.converged.all()), f"{tag} {solver}: every lane converged")
    check((tr < TRUE_RESIDUAL_MAX).all(),
          f"{tag} {solver}: float64 true residuals {tr}")
    per = ms / max(res.iterations, 1)
    print(f"[{phase}] {tag} {solver}: {res.iterations} iters, prep "
          f"{prep_ms:.1f} "
          f"ms, solve {ms:.1f} ms ({per:.4f} ms/iteration), converged=True, "
          f"float64 true residual max {tr.max():.3e}", flush=True)
    return res.iterations, per, float(tr.max())


def timed(fn):
    """(fn(), milliseconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3

FEM_MAX_ITERS = 40000    # plain CG on fem2d-30000 takes about 23,000
# exact IC(0)-PCG on fem2d-30000 runs a fixed budget: each application is
# an eager loop over 2 x 323 dependency levels (50-86 ms an iteration), so
# the whole solve (some 9,000 iterations) would not fit the run's time
# limit; (b) takes exact IC(0)-PCG to the tolerance
EXACT_FEM_ITERS = 300


def strict_triangle_times(tag, P, seed):
    """[13] ``spmm`` at L_MULTI on the strict triangle ``P`` that a
    Jacobi sweep multiplies by (K3 on its merge plan), outside the launch
    counts: timed beside the plain version, ``torch.sparse`` and the
    bound."""
    from tpusparse_torch import spmm
    from tpusparse_torch.bench.models import spmm_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.kernels import merge_spmv, spmm_merge

    check(isinstance(P, merge_spmv.MergeDevice)
          and P.values.dtype == torch.float32,
          f"{tag}: the Jacobi strict triangle has a float32 merge plan")
    X = rand(seed, (P.num_cols, L_MULTI))
    with uncounted():
        t = time_pair(lambda: spmm(P, X),
                      lambda: spmm_merge.spmm_merge_plain(P, X))
        lib = library_csr(P)
        t["library"] = cuda_time_ms(lambda: lib @ X)
    t["bound"] = report(13, f"{tag} Jacobi lower strict triangle "
                        f"({P.num_rows} rows, {P.nnz} nnz) spmm merge (K3) "
                        f"L={L_MULTI}", t, spmv_flops(P.nnz, L_MULTI),
                        spmm_bytes(P.nnz, P.num_rows, P.num_cols, L_MULTI))
    return t


def preconditioned_phase(gen, reset_counts, read_counts):
    """[13] The ``cpu_multicg`` comparison with ``reorder='auto'`` at tol
    1e-5, each solver given the ``ReorderedPlan`` (B in and X out through
    K6) and a preconditioner built from ``A.permuted(csr)``, declared in
    the plan's order (``perm=A.perm``):
    (a) scrambled lap3d-128, float32, L = 16: CG, and PCG with Jacobi
        IC(0) (two sweeps); the C++ factorization's time and depth;
    (b) scrambled lap3d-64, float32, L = 16: SPAI-CG with its build time
        (host structure, batched QR on the card), exact IC(0)-PCG (level
        scheduled) and Jacobi IC(0)-PCG with ms per application, and CG;
        and the JAX package's call, Jacobi IC(0) of the matrix as given,
        in the caller's order, applied behind K6;
    (c) fem2d-30000 in float64, L = 1: CG and Jacobi IC(0)-PCG to tol,
        each run once; exact IC(0)-PCG for ``EXACT_FEM_ITERS``
        iterations, its float64 true residual held to its recurrence.
    Every kernel of the phase is held against its plain version on the
    phase's own operands (not counted): K6 on B, K3 (K3d) on the inner
    plan, on the Jacobi sweeps' strict triangles and on SPAI's M; (a)'s
    lower strict triangle is timed on K3 at L = 16. Returns the launch
    counts of the phase and that timing."""
    from tpusparse_torch import (
        cg_solve_multi,
        ic0_factorize,
        make_exact_ic0_preconditioner,
        make_ic0_preconditioner,
        pcg_solve_multi,
        plan_kind,
        plan_matrix,
        spai_cg_solve_multi,
        spai_inverse,
    )
    from tpusparse_torch.precond import spai
    from tpusparse_torch.precond.trisolve import _dependency_levels

    def factor(tag, csr_p):
        Lf, ms = timed(lambda: ic0_factorize(csr_p))
        nlev = int(_dependency_levels(Lf.row_offsets, Lf.col_indices,
                                      Lf.num_rows, True).max()) + 1
        print(f"[13] {tag} IC(0): {Lf.nnz} factor entries, C++ host "
              f"factorization {ms:.1f} ms, {nlev} dependency levels",
              flush=True)
        return Lf, ms

    def jacobi(tag, Lf, L, dtype, seed, perm=None):
        """Jacobi IC(0) (of a factor in the order ``perm`` declares),
        its strict triangles held against their plain versions at the
        solve's shape."""
        prec, ms = timed(lambda: make_ic0_preconditioner(
            Lf, 2, num_rhs=L, dtype=dtype, device="cuda", perm=perm))
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        for side, solver in (("lower", prec.fwd), ("upper", prec.bwd)):
            merge_vs_plain(13, f"{tag} Jacobi {side} strict triangle",
                           solver.strict, randn(seed, (Lf.num_rows, L), tdt))
        return prec, ms

    last = {}

    def solve(solver, *args, **kw):
        def run():
            last["res"] = solver(*args, **kw)
            return last["res"], last["res"].x
        return run

    def setup(tag, csr, dtype, L, B):
        A, ms = timed(lambda: plan_matrix(csr, "auto", dtype=dtype,
                                          reorder="auto", L=L,
                                          device="cuda"))
        check(getattr(A, "order", None) == "rcm",
              f"{tag}: reorder='auto' plans RCM")
        bw0, bw1 = bandwidths(csr, A)
        csr_p, p_ms = timed(lambda: A.permuted(csr))
        print(f"[13] {tag} ({csr.num_rows} rows, {csr.nnz} nnz): "
              f"{plan_kind(A)} planned in {ms:.1f} ms, bandwidth {bw0} -> "
              f"{bw1}; the host matrix in the plan's order "
              f"(A.permuted) in {p_ms:.1f} ms", flush=True)
        merge_vs_plain(13, f"{tag} inner", A.inner,
                       k6_vs_plain(13, tag, A, B))
        return A, ms, csr_p

    reset_counts()
    out = {}
    # (a)
    tag = "lap3d-128 scrambled float32"
    csr, _ = scrambled(gen.make_laplacian_grid3d(128).to_csr(), 5)
    B = rand(500, (csr.num_rows, L_MULTI))
    A, plan_ms, csr_p = setup(tag, csr, np.float32, L_MULTI, B)
    C = csr.to("cuda")
    out["a", "cg"] = multicg(tag, "cg", plan_ms, solve(cg_solve_multi, A, B),
                             C, B)
    Lf, f_ms = factor(tag, csr_p)
    prec, p_ms = jacobi(tag, Lf, L_MULTI, np.float32, 501, A.perm)
    t_tri = strict_triangle_times(tag, prec.fwd.strict, 502)
    out["a", "pcg"] = multicg(tag, "pcg_ic0 (2 Jacobi sweeps)", f_ms + p_ms,
                              solve(pcg_solve_multi, A, B, prec), C, B)
    del A, csr, csr_p, C, B, Lf, prec
    torch.cuda.empty_cache()
    # (b)
    tag = "lap3d-64 scrambled float32"
    csr, _ = scrambled(gen.make_laplacian_grid3d(64).to_csr(), 5)
    B = rand(510, (csr.num_rows, L_MULTI))
    A, plan_ms, csr_p = setup(tag, csr, np.float32, L_MULTI, B)
    C = csr.to("cuda")
    _, struct_ms = timed(lambda: spai._structure(csr_p))
    lstsq, qr = spai._batched_lstsq, []

    def timed_lstsq(A_b, e_b):
        out, ms = timed(lambda: lstsq(A_b, e_b))
        qr.append((A_b.shape, ms))
        return out

    spai._batched_lstsq = timed_lstsq
    try:
        M, spai_ms = timed(lambda: spai_inverse(csr_p))
    finally:
        spai._batched_lstsq = lstsq
    Mp, mp_ms = timed(lambda: plan_matrix(M, "auto", L=L_MULTI,
                                          device="cuda", dtype=np.float32))
    print(f"[13] {tag} SPAI: {M.nnz} entries, spai_inverse {spai_ms:.1f} ms "
          f"(host structure alone {struct_ms:.1f} ms; batched QR least "
          f"squares on the card {sum(ms for _, ms in qr):.1f} ms over "
          f"buckets {', '.join(f'{tuple(s)} {ms:.1f} ms' for s, ms in qr)}; "
          f"the rest is the host bucket fill and copies), plan "
          f"{plan_kind(Mp)} {mp_ms:.1f} ms", flush=True)
    merge_vs_plain(13, f"{tag} SPAI M", Mp, rand(511, (M.num_rows, L_MULTI)))
    out["b", "cg"] = multicg(tag, "cg", plan_ms, solve(cg_solve_multi, A, B),
                             C, B)
    out["b", "spai"] = multicg(tag, "spai_cg", spai_ms + mp_ms,
                               solve(spai_cg_solve_multi, A, Mp, B,
                                     perm=A.perm), C, B)
    Lf, f_ms = factor(tag, csr_p)
    precs = {}
    Bp = A.apply_perm(B)
    for name, make in (("exact IC(0), level-scheduled",
                        lambda: timed(lambda: make_exact_ic0_preconditioner(
                            Lf, perm=A.perm))),
                       ("Jacobi IC(0), 2 sweeps",
                        lambda: jacobi(tag, Lf, L_MULTI, np.float32, 512,
                                       A.perm))):
        prec, p_ms = make()
        app = min(timed(lambda: prec(Bp))[1] for _ in range(3))
        print(f"[13] {tag} {name}: built in {p_ms:.1f} ms, {app:.3f} ms per "
              f"application at L={L_MULTI}", flush=True)
        precs[name] = (prec, f_ms + p_ms, app)
    for key, name in (("pcg_exact", "exact IC(0), level-scheduled"),
                      ("pcg", "Jacobi IC(0), 2 sweeps")):
        prec, prep, app = precs[name]
        out["b", key] = multicg(tag, f"pcg_ic0 ({name})", prep,
                                solve(pcg_solve_multi, A, B, prec),
                                C, B) + (app,)
    # the JAX package's call: IC(0) of the matrix as given, in the
    # caller's order, applied behind K6 (apply_inv in, apply_perm out)
    Lc, fc_ms = factor(f"{tag} (caller's order)", csr)
    prec, p_ms = jacobi(f"{tag} (caller's order)", Lc, L_MULTI, np.float32,
                        513)
    out["b", "pcg_caller"] = multicg(
        tag, "pcg_ic0 (Jacobi IC(0) in the caller's order, behind K6)",
        fc_ms + p_ms, solve(pcg_solve_multi, A, B, prec), C, B)
    del A, csr, csr_p, C, B, Bp, Lf, Lc, prec, precs, M, Mp
    torch.cuda.empty_cache()
    # (c) the fem2d-30000 float64 acceptance
    tag = "fem2d-30000 float64"
    csr = gen.make_fem2d(30000, seed=1).to_csr()
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (csr.num_rows, 1))).cuda()
    A, plan_ms, csr_p = setup(tag, csr, np.float64, 1, B)
    C = csr.to("cuda", torch.float64)
    out["c", "cg"] = multicg(tag, "cg", plan_ms, solve(
        cg_solve_multi, A, B, max_iters=FEM_MAX_ITERS), C, B, False)
    Lf, f_ms = factor(tag, csr_p)
    prec, p_ms = jacobi(tag, Lf, 1, np.float64, 520, A.perm)
    out["c", "pcg"] = multicg(tag, "pcg_ic0 (Jacobi IC(0), 2 sweeps)",
                              f_ms + p_ms, solve(
                                  pcg_solve_multi, A, B, prec,
                                  max_iters=FEM_MAX_ITERS), C, B, False)
    jrel = float(last["res"].history[EXACT_FEM_ITERS - 1])
    name = "pcg_ic0 (exact IC(0), level-scheduled)"
    prec, p_ms = timed(lambda: make_exact_ic0_preconditioner(Lf,
                                                             perm=A.perm))
    Bp = A.apply_perm(B)
    app = min(timed(lambda: prec(Bp))[1] for _ in range(3))
    print(f"[13] {tag} exact IC(0), level-scheduled: built in {p_ms:.1f} ms, "
          f"{app:.3f} ms per application at L=1", flush=True)
    (res, X), ms = timed(solve(pcg_solve_multi, A, B, prec,
                               max_iters=EXACT_FEM_ITERS))
    rel = float(res.residual.max())
    tr = float(true_residuals(C, B, X).max())
    check(res.iterations == EXACT_FEM_ITERS and X.shape == B.shape
          and torch.isfinite(X).all()
          and bool(torch.isfinite(res.history).all()),
          f"{tag} {name}: {EXACT_FEM_ITERS} finite iterations")
    check(rel < 1 and abs(tr - rel) <= 1e-4 * rel,
          f"{tag} {name}: float64 true residual {tr} within 1e-4 of the "
          f"recurrence's {rel}")
    per = ms / EXACT_FEM_ITERS
    print(f"[13] {tag} {name}: {EXACT_FEM_ITERS} iterations of a fixed "
          f"budget, solve {ms:.1f} ms ({per:.4f} ms/iteration), relative "
          f"residual {rel:.3e}, float64 true residual {tr:.3e} (Jacobi "
          f"IC(0) at the same iteration {jrel:.3e})", flush=True)
    out["c", "pcg_exact (budget)"] = (EXACT_FEM_ITERS, per, tr)
    print("[13] iterations: " + ", ".join(
        f"({k[0]}) {k[1]} {v[0]}" for k, v in out.items()))
    return read_counts("preconditioned path", ("K6", "K3", "K3d")), t_tri


K7_LS = (2, 3, 5, 16, 32, 100, 128)


def k7_vs_plain(name, csr, L, seed, phase=2):
    """K7 on an n-major plan for L right-hand sides: bitwise equal to
    its plain version and to K1 on X.T, transposed back. Returns max
    |K7 - plain| (0)."""
    from tpusparse_torch import plan_kind, plan_matrix
    from tpusparse_torch.kernels import dia_nmajor, dia_stream

    A = plan_matrix(csr, "nmajor", L=L, device="cuda", dtype=np.float32)
    check(plan_kind(A) == "dia_nmajor", f"{name}: an n-major plan")
    X = rand(seed, (csr.num_cols, L))
    Y = dia_nmajor.nmajor_matmat(A.dia.band, X)
    Yp = dia_nmajor.spmm_nmajor_plain(A.dia.band, X)
    Y1 = dia_stream.spmm_dia_stream_t(A.dia.band, X.T.contiguous()).T
    what = f"K7 {name} ({csr.num_rows} rows) L={L}"
    check(Y.shape == (csr.num_rows, L) and torch.isfinite(Y).all(),
          f"{what}: finite Y of shape ({csr.num_rows}, {L})")
    check(torch.equal(Y, Yp), f"{what}: bitwise equal to plain")
    check(torch.equal(Y, Y1), f"{what}: bitwise equal to K1 on X.T")
    print(f"[{phase}] {what}: bitwise equal to its plain version and to K1 "
          f"on X.T (plan L {A.dia.L}, lane groups of "
          f"{dia_nmajor.k7_lane_group(L, X, Y)})")
    return float((Y - Yp).abs().max())


def bsr_row_bound(A, C64, X, u):
    """(float64 A X on the CSR ``C64``, 2 (w_i + 2) u |A||X|) for the BSR
    plan ``A``: w_i the stored entries of row i (bc per block of its
    block row)."""
    from tpusparse_torch.ops.reference import csr_matmat

    args = (C64.num_rows, C64.row_offsets, C64.col_indices)
    Y64 = csr_matmat(*args, C64.values, X.double())
    AX = csr_matmat(*args, C64.values.abs(), X.double().abs())
    per = (A.block_row_offsets[1:] - A.block_row_offsets[:-1]).double()
    w = (per * A.block_cols).repeat_interleave(A.block_rows)[:A.num_rows]
    return Y64, 2 * (w[:, None] + 2) * u * AX


def bsr_fixtures(gen):
    """(name, host CSR) of K8's checks: full (8, 128) blocks, partial
    fill, edges cut mid-block with an emptied block row, and nnz = 0."""
    from tpusparse_torch import CsrMatrix

    S = gen.make_block_random(40, 3, seed=4).to_csr().to_scipy()
    S = S[:317, :5000].tolil()
    S[16:24, :] = 0
    return [
        ("block-64x4", gen.make_block_random(64, 4).to_csr()),
        ("block-64x4-fill0.3", gen.make_block_random(64, 4, fill=0.3,
                                                     seed=1).to_csr()),
        ("edge-317x5000", CsrMatrix.from_scipy(S)),
        ("nnz-0", CsrMatrix(24, 300, np.zeros(25, np.int32),
                            np.zeros(0, np.int32), np.zeros(0))),
    ]


def k8_vs_plain(name, csr, dtype, seed):
    """[2] K8 (float32) or K8d (float64) on a 'bsr' plan at each L of
    SPMM_LS: within 2(w_i + 2)u|A||X| of its plain version and of a
    float64 CSR product, two runs bitwise equal. Returns max |kernel -
    plain|."""
    from tpusparse_torch import plan_kind, plan_matrix
    from tpusparse_torch.kernels import bsr

    A = plan_matrix(csr, "bsr", dtype=dtype, device="cuda")
    check(plan_kind(A) == "bsr", f"{name}: a bsr plan")
    C64 = csr.to("cuda", torch.float64)
    f64 = dtype == np.float64
    kernel, u = ("K8d", U64) if f64 else ("K8", U)
    worst = 0.0
    for L in SPMM_LS:
        X = (rand64 if f64 else rand)(seed + L, (csr.num_cols, L))
        Y1, Y2 = bsr.bsr_matmat(A, X), bsr.bsr_matmat(A, X)
        Yp = bsr.bsr_spmm_plain(A, X)
        Y64, bound = bsr_row_bound(A, C64, X, u)
        what = f"{kernel} {name} L={L}"
        check(Y1.shape == (csr.num_rows, L) and Y1.dtype == X.dtype
              and torch.isfinite(Y1).all(), f"{what}: finite Y of X's type")
        check(torch.equal(Y1, Y2), f"{what}: two runs bitwise equal")
        check(((Y1.double() - Yp.double()).abs() <= bound).all(),
              f"{what}: within 2(w_i+2)u|A||X| of plain")
        check(((Y1.double() - Y64).abs() <= bound).all(),
              f"{what}: within 2(w_i+2)u|A||X| of a float64 CSR product")
        if Y1.numel():
            worst = max(worst, float((Y1 - Yp).abs().max()))
    print(f"[2] {kernel} {name} {csr.num_rows}x{csr.num_cols} nnz "
          f"{csr.nnz}, {A.num_blocks} blocks L={list(SPMM_LS)}: max|"
          f"{kernel}-plain| {worst:.3e}, within 2(w_i+2)u|A||X| of plain "
          f"and of float64, bitwise repeat PASS")
    return worst


def k5_alone_times(phase, what, D, XT, fp64=False):
    """K5 (K5d) alone on (L, n) value planes, outside the launch counts:
    timed beside its plain version, ``torch.sparse`` CSR of the same
    planes in the same type on X (n, L), and the bound."""
    from tpusparse_torch.bench.models import dia_planes_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.kernels import dia_stream

    L = XT.shape[0]
    ro, c, v = dia_as_csr(D)
    lib = torch.sparse_csr_tensor(ro, c, v.to(XT.dtype),
                                  size=(D.num_rows, D.num_cols))
    X = XT.T.contiguous()
    with uncounted():
        check(torch.equal(dia_stream.spmm_dia_planes_t(D, XT),
                          dia_stream.spmm_dia_planes_plain(D, XT)),
              f"{what}: bitwise equal to its plain version")
        t = time_pair(lambda: dia_stream.spmm_dia_planes_t(D, XT),
                      lambda: dia_stream.spmm_dia_planes_plain(D, XT))
        t["library"] = cuda_time_ms(lambda: lib @ X)
    t["bound"] = report(phase, f"{what} ({D.num_rows} rows, "
                        f"{len(D.offsets)} planes) alone on (L, n) L={L}",
                        t, spmv_flops(int(v.numel()), L),
                        dia_planes_bytes(D.num_rows, D.num_cols,
                                         len(D.offsets), L,
                                         D.data.element_size(),
                                         XT.element_size()), fp64=fp64)
    return t


def nmajor_phase(gen, lap160, reset_counts, read_counts):
    """[14] The n-major path at full width, lap3d-160 at L = 16:
    ``spmm`` on ``strategy='nmajor'`` (K7, (n, L) with no transposes)
    and on AUTO (K7 on the AUTO plan's band, no second plan), each
    checked against float64, held bitwise against its plain version (and
    K7 against K1 on X.T), and timed, with K7 alone, beside the plain
    versions, ``torch.sparse`` and the bound; ``cg_solve_multi`` on both
    plans (iterations within 1, ms/iteration); Jacobi IC(0)-PCG at L = 16
    on natural-order lap3d-128 on both plans (the n-major plan hands the
    preconditioner (n, L) blocks, AUTO behind two transposes an
    iteration), with K7 on B and K5 on the Jacobi strict triangles held
    against their plain versions, and K5 timed alone on the lower one.
    Returns (launch counts, K7 timings, K5 timings)."""
    from tpusparse_torch import (
        cg_solve_multi,
        ic0_factorize,
        make_ic0_preconditioner,
        pcg_solve_multi,
        plan_kind,
        plan_matrix,
        spmm,
    )
    from tpusparse_torch.bench.models import dia_masked_bytes, spmv_flops
    from tpusparse_torch.bench.timing import cuda_time_ms
    from tpusparse_torch.formats.dia import DiaDevice
    from tpusparse_torch.kernels import dia_nmajor, dia_stream
    from tpusparse_torch.ops.hybrid import HybridPlan
    from tpusparse_torch.ops.reference import csr_matmat

    reset_counts()
    n = lap160.num_rows
    N = plan_matrix(lap160, "nmajor", L=L_MULTI, device="cuda",
                    dtype=np.float32)
    A = plan_matrix(lap160, "auto", L=L_MULTI, device="cuda", dtype=np.float32)
    check(plan_kind(N) == "dia_nmajor" and N.dia.L == L_MULTI,
          "lap3d-160 'nmajor' at L=16 plans K7")
    check(plan_kind(A) == "dia" and isinstance(
        A.dia, dia_stream.DiaStreamDevice), "lap3d-160 AUTO plans K1")
    C = lap160.to("cuda")
    X = rand(600, (n, L_MULTI))
    XT = X.T.contiguous()
    Y64, bound, _ = row_bound(C, X)
    Ys = []
    for label, P in (("nmajor (K7)", N), ("auto (K7 on its band)", A)):
        Y = spmm(P, X)
        check(Y.shape == (n, L_MULTI) and torch.isfinite(Y).all()
              and ((Y.double() - Y64).abs() <= bound).all(),
              f"lap3d-160 spmm {label}: Y within (nnz_i+2)u|A||X| of "
              "float64")
        Ys.append(Y)
    with uncounted():
        check(torch.equal(Ys[0],
                          dia_nmajor.spmm_nmajor_plain(N.dia.band, X)),
              "lap3d-160 L=16 K7 (spmm on the n-major plan): bitwise equal "
              "to its plain version")
        check(torch.equal(Ys[1], dia_stream.spmm_dia_masked_plain(
            A.dia, XT).T), "lap3d-160 L=16 K1 (spmm on the AUTO plan): "
              "bitwise equal to its plain version")
    check(torch.equal(Ys[0], Ys[1]), "lap3d-160 L=16: K7 bitwise equal to "
          "K1 on X.T")
    print(f"[14] lap3d-160 L={L_MULTI}: K7 bitwise equal to its plain "
          "version and to K1 on X.T (AUTO's spmm); K1 bitwise equal to its "
          "plain version", flush=True)
    # K7 at an odd L (lane groups of one value) and at the widest plan
    with uncounted():
        lap40 = gen.make_laplacian_grid3d(40).to_csr()
        for L in (3, 128):
            k7_vs_plain("lap3d-40", lap40, L, 620 + L, phase=14)
        del lap40
    del Ys, Y
    lib = library_csr(C)
    fl = spmv_flops(lap160.nnz, L_MULTI)
    nbytes = dia_masked_bytes(n, L_MULTI)
    with uncounted():
        lib_ms = cuda_time_ms(lambda: lib @ X)
        rows = {
            "K7 alone on (n, L)": time_pair(
                lambda: dia_nmajor.nmajor_matmat(N.dia.band, X),
                lambda: dia_nmajor.spmm_nmajor_plain(N.dia.band, X)),
            "spmm on the n-major plan (K7)": time_pair(
                lambda: spmm(N, X),
                lambda: dia_nmajor.spmm_nmajor_plain(N.dia.band, X)),
            "spmm on the AUTO plan (K7 on its band)": time_pair(
                lambda: spmm(A, X),
                lambda: dia_stream.spmm_dia_masked_plain(A.dia, XT).T),
            "K1 alone on (L, n)": time_pair(
                lambda: dia_stream.spmm_dia_stream_t(A.dia, XT),
                lambda: dia_stream.spmm_dia_masked_plain(A.dia, XT)),
        }
    for what, t in rows.items():
        t["library"] = lib_ms
        t["bound"] = report(14, f"lap3d-160 L={L_MULTI} {what}", t, fl,
                            nbytes)
    del lib
    X_true = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (n, L_MULTI))).cuda()
    B = csr_matmat(C.num_rows, C.row_offsets, C.col_indices,
                   C.values.double(), X_true).float()
    cg = {label: run_cg_multi(f"lap3d-160 {label}", P, C, B, phase=14)
          for label, P in (("nmajor (K7, (n, L) state)", N),
                           ("auto (K1, (L, n) state)", A))}
    (it_n, ms_n, _), (it_a, ms_a, _) = cg.values()
    check(abs(it_n - it_a) <= 1, f"lap3d-160 cg_solve_multi: n-major {it_n}"
          f" iterations within 1 of AUTO's {it_a}")
    print(f"[14] lap3d-160 cg_solve_multi L={L_MULTI}: n-major {it_n} "
          f"iterations, {ms_n:.4f} ms/iteration; AUTO {it_a}, {ms_a:.4f} "
          "ms/iteration", flush=True)
    del N, A, C, X, XT, Y64, bound, X_true, B
    torch.cuda.empty_cache()
    # Jacobi IC(0)-PCG on natural-order lap3d-128
    lap128 = gen.make_laplacian_grid3d(128).to_csr()
    N = plan_matrix(lap128, "nmajor", L=L_MULTI, device="cuda",
                    dtype=np.float32)
    A = plan_matrix(lap128, "auto", L=L_MULTI, device="cuda", dtype=np.float32)
    C = lap128.to("cuda")
    Lf, f_ms = timed(lambda: ic0_factorize(lap128))
    prec, p_ms = timed(lambda: make_ic0_preconditioner(
        Lf, 2, num_rhs=L_MULTI, dtype=np.float32, device="cuda"))
    B = rand(610, (lap128.num_rows, L_MULTI))
    BT = B.T.contiguous()
    with uncounted():
        check(torch.equal(dia_nmajor.nmajor_matmat(N.dia.band, B),
                          dia_nmajor.spmm_nmajor_plain(N.dia.band, B)),
              "lap3d-128 L=16 K7 on B: bitwise equal to its plain version")
        for side, solver in (("lower", prec.fwd), ("upper", prec.bwd)):
            S = solver.strict
            what = f"lap3d-128 Jacobi {side} strict triangle"
            check(isinstance(S, HybridPlan) and S.rest is None
                  and isinstance(S.dia, DiaDevice),
                  f"{what}: a pure value-plane plan (K5)")
            check(torch.equal(dia_stream.spmm_dia_planes_t(S.dia, BT),
                              dia_stream.spmm_dia_planes_plain(S.dia, BT)),
                  f"{what}: K5 on B bitwise equal to its plain version")
    print(f"[14] lap3d-128 L={L_MULTI}: K7 on B and K5 on both Jacobi strict "
          "triangles bitwise equal to their plain versions", flush=True)
    t_tri = k5_alone_times(14, "lap3d-128 Jacobi lower strict triangle K5",
                           prec.fwd.strict.dia, BT)
    del BT

    def pcg_on(P):
        def run():
            res = pcg_solve_multi(P, B, prec)
            return res, res.x
        return run

    pcg = {label: multicg("lap3d-128", f"pcg_ic0 (2 Jacobi sweeps) on "
                          f"{label}", f_ms + p_ms, pcg_on(P), C, B,
                          phase=14)
           for label, P in (("nmajor (K7, no transposes)", N),
                            ("auto (K1, two transposes an iteration)", A))}
    (it_n, ms_n, _), (it_a, ms_a, _) = pcg.values()
    check(abs(it_n - it_a) <= 1, f"lap3d-128 Jacobi IC(0)-PCG: n-major "
          f"{it_n} iterations within 1 of AUTO's {it_a}")
    print(f"[14] lap3d-128 Jacobi IC(0)-PCG L={L_MULTI}: n-major {it_n} "
          f"iterations, {ms_n:.4f} ms/iteration; AUTO {it_a}, {ms_a:.4f} "
          "ms/iteration", flush=True)
    counts = read_counts("n-major path", ("K7", "K1"))
    return counts, rows["K7 alone on (n, L)"], t_tri


def bsr_phase(gen, reset_counts, read_counts):
    """[15] The BSR path at full width: ``make_block_random(8192, 4,
    seed=0)`` (65,536 x 1,048,576, 33.5M nnz, 134 MB of float32 blocks)
    through ``plan_matrix(..., 'bsr')``: ``spmv`` and ``spmm`` at L = 1
    and 16 on K8, and on K8d in float64, each checked against a float64
    product and its plain version under 2(w_i + 2)u|A||X| and timed
    beside the plain version,
    ``torch.sparse`` CSR, ``torch.sparse_bsr_tensor`` (where PyTorch
    takes (8, 128) blocks on the card), the bound, and K3 on the merge
    plan of the same matrix. Returns (launch counts, timings by
    (kernel, L))."""
    from tpusparse_torch import plan_kind, plan_matrix, spmm, spmv
    from tpusparse_torch.bench.models import (
        bound_ms,
        bsr_bytes,
        bsr_flops,
        spmm_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.formats.bcsr import fill_estimate
    from tpusparse_torch.kernels import bsr

    (csr, ms) = timed(lambda: gen.make_block_random(8192, 4,
                                                    seed=0).to_csr())
    fe, fe_ms = timed(lambda: fill_estimate(csr, 8, 128))
    print(f"[15] make_block_random(8192, 4): {csr.num_rows} x "
          f"{csr.num_cols}, {csr.nnz} nnz, built in {ms:.1f} ms; "
          f"fill_estimate(8, 128) {fe:.4f} ({fe_ms:.1f} ms; the JAX "
          "package's AUTO gate plans BSR at >= 0.3)", flush=True)
    reset_counts()
    plans, plan_ms = {}, {}
    for dt in (np.float32, np.float64):
        plans[dt], plan_ms[dt] = timed(
            lambda: plan_matrix(csr, "bsr", dtype=dt, device="cuda"))
    B32, B64 = plans[np.float32], plans[np.float64]
    check(plan_kind(B32) == "bsr" and plan_kind(B64) == "bsr"
          and B64.blocks.dtype == torch.float64, "make_block_random: 'bsr' "
          "plans in both types")
    print(f"[15] bsr plans: {B32.num_blocks} (8, 128) blocks, fill ratio "
          f"{B32.fill_ratio:.4f}, {B32.blocks.numel() * 4 / 1e6:.1f} MB of "
          f"float32 blocks; planned in {plan_ms[np.float32]:.1f} ms "
          f"(float64 {plan_ms[np.float64]:.1f} ms)", flush=True)
    M = plan_matrix(csr, "merge", L=L_MULTI, device="cuda", dtype=np.float32)
    C64 = csr.to("cuda", torch.float64)
    lib = library_csr(M)
    lib64 = library_csr(C64)
    try:
        lib_bsr = torch.sparse_bsr_tensor(
            B32.block_row_offsets, B32.block_col_indices, B32.blocks,
            size=(csr.num_rows, csr.num_cols))
        lib_bsr @ torch.zeros(csr.num_cols, 1, device="cuda")
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"[15] torch.sparse_bsr_tensor with (8, 128) blocks on the "
              f"card: not taken ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]})", flush=True)
        lib_bsr = None
    out = {}
    for L in (1, L_MULTI):
        for f64 in (False, True):
            kernel, P, u = ("K8d", B64, U64) if f64 else ("K8", B32, U)
            X = (rand64 if f64 else rand)(620 + L, (csr.num_cols, L))
            x = X[:, 0].contiguous()
            Y = spmv(P, x)[:, None] if L == 1 else spmm(P, X)
            Y64, bound = bsr_row_bound(P, C64, X, u)
            what = f"make_block_random(8192, 4) {kernel} L={L}"
            check(Y.shape == (csr.num_rows, L) and Y.dtype == X.dtype
                  and torch.isfinite(Y).all(), f"{what}: finite Y")
            check(((Y.double() - Y64).abs() <= bound).all(),
                  f"{what}: within 2(w_i+2)u|A||X| of a float64 product")
            with uncounted():
                Yp = bsr.bsr_spmm_plain(P, X)
            err = float((Y - Yp).abs().max())
            check(((Y.double() - Yp.double()).abs() <= bound).all(),
                  f"{what}: within 2(w_i+2)u|A||X| of its plain version")
            print(f"[15] {what}: max|{kernel}-plain| {err:.3e}, within "
                  "2(w_i+2)u|A||X| of its plain version and of float64",
                  flush=True)
            del Yp
            call = ((lambda: spmv(P, x)) if L == 1
                    else (lambda: spmm(P, X)))
            with uncounted():
                t = time_pair(call, lambda: bsr.bsr_spmm_plain(P, X))
                t["library"] = cuda_time_ms(
                    lambda: (lib64 if f64 else lib) @ X)
                extra = ""
                if not f64:
                    k3 = (cuda_time_ms(lambda: spmm(M, X)),
                          graph_time_ms(lambda: spmm(M, X)))
                    k3_bound = bound_ms(spmv_flops(csr.nnz, L), spmm_bytes(
                        csr.nnz, csr.num_rows, csr.num_cols, L))[0]
                    extra = (f"; K3 on the merge plan {k3[0]:.4f} ms/call, "
                             f"device {k3[1]:.4f} ms (CSR bound "
                             f"{k3_bound:.4f} ms)")
                    if lib_bsr is not None:
                        bsr_ms = cuda_time_ms(lambda: lib_bsr @ X)
                        extra += f"; torch.sparse_bsr_tensor {bsr_ms:.4f} "\
                            "ms/call"
            t["bound"] = report(15, what, t,
                                bsr_flops(P.num_blocks, 8, 128, L),
                                bsr_bytes(P.num_blocks, 8, 128, csr.num_rows,
                                          csr.num_cols, L, 8 if f64 else 4),
                                fp64=f64)
            if extra:
                print(f"[15] {what}{extra}", flush=True)
            out[kernel, L] = t
            del X, x, Y, Y64, bound
    counts = read_counts("BSR path", ("K8", "K8d"))
    del plans, B32, B64, M, C64, lib, lib64, lib_bsr
    torch.cuda.empty_cache()
    return counts, out



def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from tpusparse_torch import CsrMatrix, plan_kind, plan_matrix
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.io.market import read_market
    from tpusparse_torch.kernels import _build, dia_stream, merge_spmv
    from tpusparse_torch.ops.reference import csr_matmat, csr_matvec
    from tpusparse_torch.ops.reorder import ReorderedPlan

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
    D48 = plan_matrix(lap48, "auto", device="cuda", dtype=np.float32).dia
    k1_err = max(k1_vs_plain("lap3d-48", D48, L, 10 + L) for L in (1, 4, 16))
    k1_more = k1_checks(gen, plan_matrix)
    k1_err = max(k1_err, k1_more["K1"])
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
    kr_err = kr_checks(fixtures)
    k3_err = max(spmm_vs_plain("K3", name, csr, 40 + i)
                 for i, (name, csr) in enumerate(fixtures))
    # K4 and K4d also bitwise against their plain versions on CPU copies
    k4_err = max(spmm_vs_plain("K4", name, csr, 60 + i, cpu_copy=True)
                 for i, (name, csr) in enumerate(fixtures))
    rmat18 = fixtures[1][1]
    k5_err = max(
        k5_vs_plain(name, dia_planes_of(csr, pd), L, 80 + L)
        for name, csr in plane_fixtures(gen, read_market)
        for pd in (torch.float32, torch.bfloat16) for L in (1, 4, 16))
    # the float64 twins on the same fixtures
    D48d = plan_matrix(lap48, "auto", dtype=np.float64, device="cuda").dia
    err64 = {"K1d": max(k1_more["K1d"], *(
        kd_dia_vs_plain("K1d", "lap3d-48", D48d, L, 90 + L)
        for L in F64_LS))}
    for kernel, seed in (("K2d", 100), ("K3d", 120), ("K4d", 140)):
        err64[kernel] = max(
            kd_csr_vs_plain(kernel, name, csr, seed + i,
                            cpu_copy=kernel == "K4d")
            for i, (name, csr) in enumerate(fixtures))
    err64["K5d"] = max(
        kd_dia_vs_plain("K5d", name, dia_planes_of(csr, torch.float64), L,
                        160 + L)
        for name, csr in plane_fixtures(gen, read_market) for L in F64_LS)
    # K6 on small permutations and on the RCM permutation that
    # reorder='auto' plans for scrambled lap3d-160 (the plan [12] drives)
    lap160 = gen.make_laplacian_grid3d(160).to_csr()
    scr160, p160 = scrambled(lap160, 5)
    A12, plan12_ms = timed(lambda: plan_matrix(scr160, "auto",
                                               reorder="auto",
                                               device="cuda",
                                               dtype=np.float32))
    check(isinstance(A12, ReorderedPlan) and A12.order == "rcm",
          "scrambled lap3d-160: reorder='auto' plans RCM")
    k6_err = k6_checks(A12.perm.cpu().numpy())
    # K7 on n-major plans; K8 and K8d on bsr plans
    k7_err = max(
        k7_vs_plain(name, csr, L, 640 + L)
        for name, csr in (("lap3d-48", lap48),
                          ("lap2d-300", gen.make_laplacian_grid2d(
                              300).to_csr()),
                          ("lap3d-47", gen.make_laplacian_grid3d(
                              47).to_csr()))
        for L in K7_LS)
    bsr_fx = bsr_fixtures(gen)
    k8_err = max(k8_vs_plain(name, csr, np.float32, 660 + 10 * i)
                 for i, (name, csr) in enumerate(bsr_fx))
    k8d_err = max(k8_vs_plain(name, csr, np.float64, 700 + 10 * i)
                  for i, (name, csr) in enumerate(bsr_fx))
    del bsr_fx
    torch.cuda.synchronize()
    print(f"[2] done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # [3]-[4] the single-RHS path; count launches from here on
    counters = launch_counters()

    def reset_counts():
        counters.clear()

    def read_counts(what, must):
        torch.cuda.synchronize()
        counts = {k: counters[k] for k in KERNELS}
        print(f"[5] {what} launches: {counts}", flush=True)
        check(all(counts[k] > 0 for k in must),
              f"{', '.join(must)} launched on the {what}")
        return counts

    reset_counts()
    slice_spmv(3, "lap3d-48", lap48, 30)
    A160, M160, t160 = slice_spmv(4, "lap3d-160", lap160, 31)
    from tpusparse_torch import spmm, spmv

    x160 = rand(31, lap160.num_cols)
    launch_split(4, "lap3d-160 spmv merge (K2)", lambda: spmv(M160, x160),
                 K2_KERNELS)
    t4_rmat = k2_spmv_times("rmat-18-ef16", rmat18, 39)
    x_true = np.random.default_rng(32).standard_normal(lap160.num_cols)
    b160 = (lap160.to_scipy() @ x_true).astype(np.float32)
    it_cg160 = run_cg("lap3d-160 auto (K1)", A160, lap160,
                      torch.from_numpy(b160).cuda())[0]
    rmat_spd17 = gen.make_rmat_spd(17, edge_factor=4).to_csr()
    gr = read_market(ROOT / "data/real/gr_30_30.mtx").to_csr()
    for tag, csr in (("rmat_spd-17-ef4 merge (K2)", rmat_spd17),
                     ("gr_30_30 merge (K2)", gr)):
        b = rand(33, csr.num_rows)
        run_cg(tag, plan_matrix(csr, "merge", device="cuda",
                                dtype=np.float32), csr, b)
    path1 = read_counts("single-RHS path", ("K1", "K2", "KR"))

    # [6]-[7] the multi-RHS path, counted from 0 again
    reset_counts()
    del A160, M160
    A16 = plan_matrix(lap160, "auto", L=L_MULTI, device="cuda",
                      dtype=np.float32)
    M16 = plan_matrix(lap160, "merge", L=L_MULTI, device="cuda",
                      dtype=np.float32)
    t6 = slice_spmm("lap3d-160", lap160, M16, (
        ("auto", A16, "K1", "dia"), ("merge", M16, "K3", "merge"),
        ("row_split", row_split_plan(6, "lap3d-160", lap160), "K4",
         "row_split")), 34)
    X16 = rand(34, (lap160.num_cols, L_MULTI))
    launch_split(6, "lap3d-160 spmm merge (K3)", lambda: spmm(M16, X16),
                 K3_KERNELS)
    del X16
    Mr = plan_matrix(rmat18, "auto", L=L_MULTI, device="cuda",
                     dtype=np.float32)
    t6r = slice_spmm("rmat-18-ef16", rmat18, Mr, (
        ("auto", Mr, "K3", "merge"),
        ("row_split", row_split_plan(6, "rmat-18-ef16", rmat18), "K4",
         "row_split")), 35)
    del Mr
    X_true = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (lap160.num_cols, L_MULTI))).cuda()
    B160 = csr_matmat(M16.num_rows, M16.row_offsets, M16.col_indices,
                      M16.values.double(), X_true).float()
    it_multi160 = run_cg_multi("lap3d-160 auto (K1, (L, n) state)", A16, M16,
                               B160)[0]
    R17 = plan_matrix(rmat_spd17, "auto", L=L_MULTI, device="cuda",
                      dtype=np.float32)
    check(isinstance(R17, merge_spmv.MergeDevice),
          "rmat_spd-17-ef4 AUTO at L=16 plans merge")
    run_cg_multi("rmat_spd-17-ef4 auto (K3)", R17, R17,
                 rand(37, (rmat_spd17.num_rows, L_MULTI)))
    G = plan_matrix(gr, "row_split", L=L_MULTI, device="cuda",
                    dtype=np.float32)
    run_cg_multi("gr_30_30 row_split (K4)", G, G,
                 rand(38, (gr.num_rows, L_MULTI)))
    path2 = read_counts("multi-RHS path", ("K1", "K3", "K4"))
    del A16, M16, B160, X_true, R17, G
    torch.cuda.empty_cache()

    # [8] variable-coefficient operators, one right-hand side, counted
    # from 0 again
    from tpusparse_torch import cg_solve_bf16, cg_solve_refined_f32, spmm
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
    W = plan_matrix(var7, "auto", L=L_MULTI, device="cuda", dtype=np.float32)
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
    L32 = plan_matrix(lap160, "auto", device="cuda", dtype=np.float32)
    run_solve(10, "cg_refined lap3d-160 (K1 inner, K1d residuals)",
              lambda: cg_solve_refined(L32, L64, b64), lap160, b64,
              REFINE_TOL, REFINE_TRUE_MAX)
    del L32, L64, b64
    V64, t10_k5 = slice_fp64_spmv("var-7-160", var7, "auto", "K5d", 52)
    t10_k5_16 = k5_alone_times(10, "var-7-160 K5d float64", V64.dia,
                               rand64(60, (L_MULTI, var7.num_cols)),
                               fp64=True)
    b7 = torch.from_numpy(var7.to_scipy() @ np.random.default_rng(
        53).standard_normal(var7.num_cols)).cuda()
    V32 = plan_matrix(var7, "auto", device="cuda", dtype=np.float32)
    run_solve(10, "cg_refined var-7-160 (K5 inner, K5d residuals)",
              lambda: cg_solve_refined(V32, V64, b7), var7, b7, REFINE_TOL,
              REFINE_TRUE_MAX)
    del V32, V64, b7
    R18, t10_k2 = slice_fp64_spmv("rmat-18-ef16", rmat18, "merge", "K2d",
                                  54)
    x18 = rand64(54, rmat18.num_cols)
    launch_split(10, "rmat-18-ef16 spmv float64 merge (K2d)",
                 lambda: spmv(R18, x18), K2_KERNELS)
    del R18
    with uncounted():
        t10_k2lap = slice_fp64_spmv("lap3d-160", lap160, "merge", "K2d",
                                    59)[1]
    R64 = plan_matrix(rmat_spd17, "auto", dtype=np.float64, device="cuda")
    check(isinstance(R64, merge_spmv.MergeDevice),
          "rmat_spd-17-ef4 AUTO float64 plans merge (K2d)")
    b17 = rand64(55, rmat_spd17.num_rows)
    run_solve(10, "cg float64 rmat_spd-17-ef4 auto (K2d)",
              lambda: cg_solve(R64, b17, max_iters=10000,
                               tolerance=CG64_TOL),
              rmat_spd17, b17, CG64_TOL, CG64_TRUE_MAX)
    R32 = plan_matrix(rmat_spd17, "auto", device="cuda", dtype=np.float32)
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
    t11_lap = slice_fp64_spmm("lap3d-160", lap160, C64, (
        ("auto", M64, "K1d"),
        ("merge", plan_matrix(lap160, "merge", dtype=np.float64, L=L_MULTI,
                              device="cuda"), "K3d"),
        ("row_split", row_split_plan(11, "lap3d-160", lap160, np.float64),
         "K4d"), ("reference", C64, "KRd")), 56)
    X_true = rand64(57, (lap160.num_cols, L_MULTI))
    B64 = csr_matmat(C64.num_rows, C64.row_offsets, C64.col_indices,
                     C64.values, X_true)
    M32 = plan_matrix(lap160, "auto", L=L_MULTI, device="cuda",
                      dtype=np.float32)
    run_refined_multi("lap3d-160 (K1 inner, K1d residuals)", M32, M64, C64,
                      B64)
    del C64, M64, M32, X_true, B64
    torch.cuda.empty_cache()
    Cr = plan_matrix(rmat18, "reference", dtype=np.float64, device="cuda")
    t11 = slice_fp64_spmm("rmat-18-ef16", rmat18, Cr, (
        ("merge", plan_matrix(rmat18, "merge", dtype=np.float64, L=L_MULTI,
                              device="cuda"), "K3d"),
        ("row_split", row_split_plan(11, "rmat-18-ef16", rmat18,
                                     np.float64), "K4d")), 58)
    del Cr
    t11_fem = fem2d_k3d_times(gen)
    path6 = read_counts("float64 multi-RHS path",
                        ("K1d", "K3d", "K4d", "KRd"))
    torch.cuda.empty_cache()

    # [12] the reordered path at full width, counted from 0 again
    from tpusparse_torch import plan_kind, spmv
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms

    reset_counts()
    bw0, bw1 = bandwidths(scr160, A12)
    print(f"[12] scrambled lap3d-160 ({scr160.num_rows} rows, {scr160.nnz} "
          f"nnz): reorder='auto' plans {plan_kind(A12)} in {plan12_ms:.1f} "
          f"ms; bandwidth {bw0} -> {bw1}", flush=True)
    C12 = scr160.to("cuda")
    S12 = plan_matrix(scr160, "auto", device="cuda", dtype=np.float32)
    x = rand(400, scr160.num_cols)
    args = (C12.num_rows, C12.row_offsets, C12.col_indices)
    y64 = csr_matvec(*args, C12.values.double(), x.double())
    ax = csr_matvec(*args, C12.values.abs().double(), x.abs().double())
    for label, P in (("reordered", A12), (f"own AUTO ({plan_kind(S12)})",
                                          S12)):
        y = spmv(P, x)
        check(torch.isfinite(y).all() and y.shape == (scr160.num_rows,),
              f"scrambled lap3d-160 spmv {label}: finite y")
        check(((y.double() - y64).abs() <= 16 * U * ax).all(),
              f"scrambled lap3d-160 spmv {label}: y within 16u|A||x|")
        call = (cuda_time_ms(lambda: spmv(P, x)),
                graph_time_ms(lambda: spmv(P, x)))
        print(f"[12] scrambled lap3d-160 spmv {label}: {call[0]:.4f} ms/call,"
              f" device {call[1]:.4f} ms")
    merge_vs_plain(12, "scrambled lap3d-160 inner", A12.inner,
                   k6_vs_plain(12, "scrambled lap3d-160", A12, x))
    lib = library_csr(C12)
    print(f"[12] scrambled lap3d-160 torch.sparse: "
          f"{cuda_time_ms(lambda: lib @ x):.4f} ms/call")
    del lib, S12
    t12 = {L: k6_times(12, "lap3d-160 RCM", A12.perm, L) for L in (1, L_MULTI)}
    it = run_cg("lap3d-160 scrambled, reorder='auto' (K6 + K2)", A12, scr160,
                torch.from_numpy(b160[p160]).cuda(), phase=12)[0]
    check(abs(it - it_cg160) <= 1, f"reordered CG {it} iterations within 1 "
          f"of the unscrambled {it_cg160}")
    X_true = np.random.default_rng(36).standard_normal(
        (lap160.num_cols, L_MULTI))
    B12 = torch.from_numpy((lap160.to_scipy() @ X_true).astype(np.float32)
                           [p160]).cuda()
    merge_vs_plain(12, "scrambled lap3d-160 inner", A12.inner,
                   k6_vs_plain(12, "scrambled lap3d-160", A12, B12))
    it = run_cg_multi("lap3d-160 scrambled, reorder='auto' (K6 + K3)", A12,
                      C12, B12, phase=12)[0]
    check(abs(it - it_multi160) <= 1, f"reordered multi-RHS CG {it} "
          f"iterations within 1 of the unscrambled {it_multi160}")
    print(f"[12] iterations: cg_solve {it_cg160} unscrambled, reordered "
          f"within 1; cg_solve_multi L={L_MULTI} {it_multi160} unscrambled, "
          f"reordered within 1")
    path7 = read_counts("reordered path", ("K6", "K2", "K3"))
    del A12, C12, B12, X_true, scr160
    torch.cuda.empty_cache()

    # [13] the preconditioned solvers, counted from 0 again
    path8, t13 = preconditioned_phase(gen, reset_counts, read_counts)
    torch.cuda.empty_cache()

    # [14] the n-major path at full width, counted from 0 again
    path9, t14, t14_k5 = nmajor_phase(gen, lap160, reset_counts,
                                      read_counts)
    del lap160
    torch.cuda.empty_cache()

    # [15] the BSR path at full width, counted from 0 again
    path10, t15 = bsr_phase(gen, reset_counts, read_counts)
    paths = (path1, path2, path3, path4, path5, path6, path7, path8, path9,
             path10)
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
        entry("K2 merge-path CSR SpMV", "merge_spmv.cu",
              "tpusparse/kernels/merge_spmv.py:672", "K2", k2_err,
              t4_rmat, "rmat-18-ef16 spmv L=1, device time"),
        entry("K3 merge-path CSR SpMM", "merge_spmm.cu",
              "tpusparse/kernels/spmm_merge.py:161", "K3", k3_err,
              t6["K3"], f"lap3d-160 spmm L={L_MULTI}, device time"),
        entry("K3 merge-path CSR SpMM", "merge_spmm.cu",
              "tpusparse/kernels/spmm_merge.py:161", "K3", k3_err,
              t6r["K3"], f"rmat-18-ef16 spmm L={L_MULTI}, device time"),
        entry("K3 merge-path CSR SpMM", "merge_spmm.cu",
              "tpusparse/kernels/spmm_merge.py:161", "K3", k3_err, t13,
              f"Jacobi lower strict triangle of scrambled lap3d-128 (RCM) "
              f"spmm L={L_MULTI}, device time"),
        entry("K4 row-split CSR SpMM", "rowsplit_spmm.cu",
              "tpusparse/kernels/ell_spmm.py:132", "K4", k4_err,
              t6["K4"], f"lap3d-160 spmm L={L_MULTI}, device time"),
        entry("K4 row-split CSR SpMM", "rowsplit_spmm.cu",
              "tpusparse/kernels/ell_spmm.py:132", "K4", k4_err,
              t6r["K4"], f"rmat-18-ef16 spmm L={L_MULTI}, device time"),
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
              t11_lap["K1d"], f"lap3d-160 spmm float64 L={L_MULTI} on (L, "
              "n), device time"),
        entry("K2d merge-path CSR SpMV, float64", "merge_spmv.cu",
              "tpusparse/kernels/merge_df.py:287", "K2d", err64["K2d"],
              t10_k2, "rmat-18-ef16 spmv float64 L=1, device time"),
        entry("K2d merge-path CSR SpMV, float64", "merge_spmv.cu",
              "tpusparse/kernels/merge_df.py:287", "K2d", err64["K2d"],
              t10_k2lap, "lap3d-160 spmv float64 L=1, device time"),
        entry("K3d merge-path CSR SpMM, float64", "merge_spmm.cu",
              "tpusparse/kernels/merge_df.py:495", "K3d", err64["K3d"],
              t11["K3d"], f"rmat-18-ef16 spmm float64 L={L_MULTI}, device "
              "time"),
        entry("K3d merge-path CSR SpMM, float64", "merge_spmm.cu",
              "tpusparse/kernels/merge_df.py:495", "K3d", err64["K3d"],
              t11_lap["K3d"], f"lap3d-160 spmm float64 L={L_MULTI}, device "
              "time"),
        entry("K3d merge-path CSR SpMM, float64", "merge_spmm.cu",
              "tpusparse/kernels/merge_df.py:495", "K3d", err64["K3d"],
              t11_fem, "fem2d-30000 RCM inner plan spmm float64 L=1, "
              "device time"),
        entry("K4d row-split CSR SpMM, float64", "rowsplit_spmm.cu",
              "tpusparse/kernels/ell_df.py:186", "K4d", err64["K4d"],
              t11["K4d"], f"rmat-18-ef16 spmm float64 L={L_MULTI}, device "
              "time"),
        entry("K4d row-split CSR SpMM, float64", "rowsplit_spmm.cu",
              "tpusparse/kernels/ell_df.py:186", "K4d", err64["K4d"],
              t11_lap["K4d"], f"lap3d-160 spmm float64 L={L_MULTI}, device "
              "time"),
        entry("K5d value-plane DIA SpMV, float64 planes", "dia_planes.cu",
              "tpusparse/kernels/dia_stream.py:332", "K5d", err64["K5d"],
              t10_k5, "var-7-160 spmv float64 L=1, device time"),
        entry("K5d value-plane DIA SpMM, float64 planes", "dia_planes.cu",
              "tpusparse/kernels/dia_stream.py:332", "K5d", err64["K5d"],
              t10_k5_16, f"var-7-160 K5d alone float64 L={L_MULTI} on "
              "(L, n), device time"),
        entry("K5 value-plane DIA SpMM, f32 planes", "dia_planes.cu", b2,
              "K5", k5_err, t14_k5, f"lap3d-128 Jacobi lower strict "
              f"triangle L={L_MULTI} on (L, n), device time"),
        entry("K6 row permutation, float32", "permute.cu",
              "tpusparse/kernels/permute.py:206", "K6", k6_err, t12[1],
              "lap3d-160 RCM permutation L=1, device time"),
        entry("K6 row permutation, float32", "permute.cu",
              "tpusparse/kernels/permute.py:206", "K6", k6_err,
              t12[L_MULTI], f"lap3d-160 RCM permutation L={L_MULTI}, "
              "device time"),
        entry("K7 n-major masked DIA SpMM", "dia_nmajor.cu",
              "tpusparse/kernels/dia_nmajor.py:286", "K7", k7_err, t14,
              f"lap3d-160 spmm L={L_MULTI} on (n, L), device time"),
        entry("K8 BSR panel SpMV", "bsr.cu", "tpusparse/kernels/bsr.py:81",
              "K8", k8_err, t15["K8", 1],
              "make_block_random(8192, 4) spmv L=1, device time"),
        entry("K8 BSR panel SpMM", "bsr.cu", "tpusparse/kernels/bsr.py:81",
              "K8", k8_err, t15["K8", L_MULTI],
              f"make_block_random(8192, 4) spmm L={L_MULTI}, device time"),
        # K8d ports the JAX package's float64 BSR product (XLA's einsum
        # and segment sum; no pallas_call)
        entry("K8d BSR panel SpMV, float64", "bsr.cu",
              "tpusparse/kernels/bsr.py:165", "K8d", k8d_err, t15["K8d", 1],
              "make_block_random(8192, 4) spmv float64 L=1, device time"),
        entry("K8d BSR panel SpMM, float64", "bsr.cu",
              "tpusparse/kernels/bsr.py:165", "K8d", k8d_err,
              t15["K8d", L_MULTI], f"make_block_random(8192, 4) spmm "
              f"float64 L={L_MULTI}, device time"),
        # KR and KRd are the reference product (strategy='reference' and
        # the golden products); the JAX package's is XLA's segment sum,
        # no pallas_call
        entry("KR CSR reference product", "csr_reference.cu",
              "tpusparse/ops/reference.py:29", "KR", kr_err["KR"],
              t160["KR"], "lap3d-160 spmv reference L=1, device time"),
        entry("KRd CSR reference product, float64", "csr_reference.cu",
              "tpusparse/ops/reference.py:42", "KRd", kr_err["KRd"],
              t11_lap["KRd"], f"lap3d-160 spmm float64 reference "
              f"L={L_MULTI}, device time"),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
