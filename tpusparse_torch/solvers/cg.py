"""Conjugate gradient, single and blocked multi-RHS (port of
``tpusparse/solvers/cg.py``).

``cg_solve``: textbook CG from x0 = 0 with the JAX package's semantics
(``_cg_solve_impl``):

  * the convergence test ``sqrt(r.r) >= ||b|| * tolerance`` comes
    before each iteration's body, so a zero or already-small b takes
    no iteration;
  * ``||b|| == 0`` is replaced by 1;
  * ``alpha = 0`` when ``p.Ap == 0`` and ``beta = 0`` when ``r.r`` was
    exactly 0, so the state never turns NaN;
  * the history holds ``sqrt(r.r) / ||b||`` per iteration, NaN past the
    last one.

``cg_solve_multi``: blocked CG on B (n, L) from X0 = 0, each lane its
own CG, with ``_cg_solve_multi_impl``'s semantics:

  * ``converged`` is updated after each iteration's body and the loop
    runs while some lane has not converged, so a zero B takes one
    iteration (single-RHS CG takes none);
  * per-lane ``alpha = 0`` where the lane has converged or ``p.Ap ==
    0``, ``beta = 0`` where it has converged or ``r.r`` was 0: a
    converged lane freezes;
  * the history holds the largest ``sqrt(r.r) / ||b||`` over the lanes.

A plan that is all diagonal runs (no remainder), masked (K1, K1d) or
value planes of any type (K5, K5d), keeps the whole state in (L, n),
the kernels' own layout, with no transposes per iteration (the JAX
package's ``_pure_dia_of`` / ``_dia_t_callable``); every other plan
keeps (n, L) and calls ``spmm``.

The state is in ``b``'s dtype: a float64 ``b`` on a float64 plan (the
kernels K1d-K5d) keeps x, r, p, the dots, ``alpha``, ``beta`` and the
history in float64 end to end.

The loops are eager: every iteration runs the plan's kernel and BLAS-1
on the device and makes one host sync, to read the convergence
test. The JAX package's plan baking and its XLA matvec swap are an
XLA-TPU workaround and have no counterpart. CUDA graphs over blocks of
iterations are later work (ROADMAP A7b).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.formats.dia import DiaDevice
from tpusparse_torch.kernels.dia_stream import (
    DiaStreamDevice,
    spmm_dia_planes_t,
    spmm_dia_stream_t,
)
from tpusparse_torch.ops.blas import (
    axpy_multiple,
    axpy_single,
    dot_multiple,
    dot_single,
    update_p_multiple,
    update_p_single,
)
from tpusparse_torch.ops.hybrid import HybridPlan
from tpusparse_torch.ops.spmv import spmm, spmv


@dataclasses.dataclass
class CgResult:
    """Result of ``cg_solve`` and, with per-lane fields, of
    ``cg_solve_multi``."""

    x: torch.Tensor          # solution (n,); (n, L) for cg_solve_multi
    iterations: int          # iterations executed
    converged: bool | torch.Tensor   # bool; (L,) bool tensor (multi)
    residual: float | torch.Tensor   # sqrt(r.r) / ||b||; (L,) (multi)
    history: torch.Tensor    # (max_iters,) or (0,); NaN past the end


def cg_solve(A, b: torch.Tensor, max_iters: int = 10000,
             tolerance: float = 1e-5,
             record_history: bool = False) -> CgResult:
    """Solve A x = b for a plan ``A`` of ``plan_matrix``; ``b`` lies on
    the plan's device, in the working dtype."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = dot_single(r, r)
    b_norm = torch.sqrt(dot_single(b, b))
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    threshold = b_norm * tolerance
    zero = torch.zeros_like(rs)
    hist = torch.full((max_iters if record_history else 0,), float("nan"),
                      dtype=b.dtype, device=b.device)
    i = 0
    while i < max_iters and bool(torch.sqrt(rs) >= threshold):
        Ap = spmv(A, p)
        pAp = dot_single(p, Ap)
        alpha = torch.where(pAp == 0, zero, rs / pAp)
        x = axpy_single(x, alpha, p)
        r = axpy_single(r, -alpha, Ap)
        rs_new = dot_single(r, r)
        if record_history:
            hist[i] = torch.sqrt(rs_new) / b_norm
        beta = torch.where(rs == 0, zero, rs_new / rs)
        p = update_p_single(r, beta, p)
        rs = rs_new
        i += 1
    rel = torch.sqrt(rs) / b_norm
    return CgResult(x=x, iterations=i, converged=bool(rel < tolerance),
                    residual=float(rel), history=hist)


def cg_solve_multi(A, B: torch.Tensor, max_iters: int = 10000,
                   tolerance: float = 1e-5,
                   record_history: bool = True) -> CgResult:
    """Solve A X = B for B (n, L) lane by lane, for a plan ``A`` of
    ``plan_matrix``; ``B`` lies on the plan's device, in the working
    dtype."""
    if B.dim() != 2:
        raise ValueError(f"B must be (n, L), got {tuple(B.shape)}")
    mm_t = _dia_t_callable(A)
    if mm_t is not None:
        XT, i, converged, rel, hist = _cg_multi_loop(
            mm_t, B.T.contiguous(), 0, max_iters, tolerance,
            record_history)
        return CgResult(x=XT.T.contiguous(), iterations=i, converged=converged,
                        residual=rel, history=hist)
    X, i, converged, rel, hist = _cg_multi_loop(
        lambda P: spmm(A, P), B, 1, max_iters, tolerance, record_history)
    return CgResult(x=X, iterations=i, converged=converged, residual=rel,
                    history=hist)


def _dia_t_callable(A):
    """The (L, num_cols) -> (L, num_rows) kernel call of a plan that is
    all diagonal runs (a bare DIA operand, or a HybridPlan with no
    remainder): K1 on a masked operand, K5 on value planes; None for
    any other plan."""
    if isinstance(A, HybridPlan) and A.rest is None:
        A = A.dia
    if isinstance(A, DiaStreamDevice):
        return lambda P: spmm_dia_stream_t(A, P)
    if isinstance(A, DiaDevice):
        return lambda P: spmm_dia_planes_t(A, P)
    return None


def _cg_multi_loop(matmat, B, lane_dim, max_iters, tolerance,
                   record_history):
    """The blocked CG loop on state laid out with the lanes on
    ``lane_dim``: 1 for the (n, L) layout (BLAS-1 of ``ops/blas.py``), 0
    for (L, n), where the dots sum over dim 1 and per-lane scalars
    broadcast as (L, 1)."""
    if lane_dim == 1:
        dot, axpy, update = dot_multiple, axpy_multiple, update_p_multiple
    else:
        def dot(a, b):
            return torch.sum(a * b, dim=1)

        def axpy(y, alpha, x):
            return y + alpha[:, None] * x

        def update(r, beta, p):
            return r + beta[:, None] * p
    L = B.shape[lane_dim]
    X = torch.zeros_like(B)
    R = B
    P = B
    b_norms = torch.sqrt(dot(B, B))
    b_norms = torch.where(b_norms == 0, torch.ones_like(b_norms), b_norms)
    rs_old = dot(R, R)
    zero = torch.zeros_like(rs_old)
    converged = torch.zeros(L, dtype=torch.bool, device=B.device)
    hist = torch.full((max_iters if record_history else 0,), float("nan"),
                      dtype=B.dtype, device=B.device)
    i = 0
    while i < max_iters and not bool(converged.all()):
        AP = matmat(P)
        pAp = dot(P, AP)
        alpha = torch.where(converged | (pAp == 0), zero, rs_old / pAp)
        X = axpy(X, alpha, P)
        R = axpy(R, -alpha, AP)
        rs_new = dot(R, R)
        rel = torch.sqrt(rs_new) / b_norms
        converged = converged | (rel < tolerance)
        if record_history:
            hist[i] = torch.max(rel)
        beta = torch.where(converged | (rs_old == 0), zero, rs_new / rs_old)
        P = update(R, beta, P)
        rs_old = rs_new
        i += 1
    return X, i, converged, torch.sqrt(rs_old) / b_norms, hist
