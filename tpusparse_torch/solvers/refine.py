"""Mixed-precision solvers (port of ``tpusparse/solvers/refine.py``).

float64 solutions at float32 speed (``_solve_refined``):

  * ``cg_solve_refined`` / ``cg_solve_multi_refined``: classic iterative
    refinement, ``r = b - A_acc x`` in float64 on a float64 plan (the
    kernels K1d-K5d), an inner CG on the float32 plan ``A32`` (K1-K5)
    for the correction ``d`` from ``r`` rounded to float32, and ``x +=
    d`` in float64. The JAX package's double-float residual plans and
    its ``jax_enable_x64`` check have no counterpart: a float64 plan
    here is IEEE float64, and the solvers raise TypeError unless
    ``A_acc`` is one and ``A32`` is a float32 plan.

float32 solutions from a bf16-plane operator (the bf16-plane part):
a variable-coefficient diagonal operator is bound by its plane traffic
at L = 1; ``ops.spmv.plan_dia_bf16`` stores the planes in bf16 (half the
bytes, an operator perturbed by about 4e-3) and full-precision residuals
on the exact float32 plan correct the error:

  * ``cg_solve_bf16``: one textbook CG on the bf16 operator whose
    recurrence residual is replaced by the exact ``b - A32 x`` every
    ``replace_every`` iterations, keeping the search direction; an
    outer guard verifies against ``A32`` and hard-restarts with
    ``p = r`` while unconverged (``_cg_bf16_impl``);
  * ``cg_solve_refined_f32`` / ``cg_solve_multi_refined_f32``:
    iterative refinement, an inner CG on the bf16 operator and an exact
    float32 residual after each correction; the loop exits on the
    largest lane's residual (``_refined_f32_impl``).

The loops are eager, with the JAX package's semantics and one host sync
per test, and call the plans' kernels (K5 for the bf16 planes). The JAX
package's plan baking (``bake``) and its fused XLA matvec are not
ported. Its baked bf16 path does its arithmetic in bf16 (ROADMAP
C-ref1); the port upcasts the planes in-register and is held to its
``bake=False`` path.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.ops.blas import dot_multiple, dot_single
from tpusparse_torch.ops.spmv import SpmvStrategy, plan_semantics, spmm, spmv
from tpusparse_torch.solvers.cg import cg_solve, cg_solve_multi


@dataclasses.dataclass
class RefineResult:
    """Result of the refinement solvers."""

    x: torch.Tensor            # solution (n,) or (n, L): float64 from
                               # the float64 refinements, else float32
    refinements: int           # outer iterations executed
    inner_iterations: int      # total inner CG iterations
    residual: torch.Tensor     # relative residual(s) on the accurate
                               # operator (float64, or float32)


@dataclasses.dataclass
class ReplCgResult:
    """Result of ``cg_solve_bf16``."""

    x: torch.Tensor      # float32 solution
    iterations: int      # total bf16-operator CG iterations
    converged: bool      # verified against the exact float32 operator
    residual: float      # exact float32 relative residual
    replacements: int    # exact-residual replacements performed
    restarts: int        # hard restarts after a failed verification


def cg_solve_bf16(A16, A32, b: torch.Tensor, tolerance: float = 1e-5,
                  max_iters: int = 10000, replace_every: int = 8,
                  max_restarts: int = 3, strategy="auto",
                  bake: bool | None = None) -> ReplCgResult:
    """Single-RHS float32-accurate CG at bf16-plane matvec speed: CG
    with the bf16-plane plan ``A16`` (``plan_dia_bf16``), the recurrence
    residual replaced by the exact ``b - A32 x`` every
    ``replace_every`` iterations while the search direction is kept.
    Convergence is verified against ``A32``; a failed verification
    restarts from the true residual (at most ``max_restarts`` times).
    ``strategy`` is validated only and ``bake`` ignored, as in
    ``cg_solve``."""
    SpmvStrategy.parse(strategy)
    b = b.to(torch.float32)
    bn = torch.sqrt(dot_single(b, b))
    bn = torch.where(bn == 0, torch.ones_like(bn), bn)
    thr = bn * tolerance
    zero = torch.zeros_like(bn)
    x = torch.zeros_like(b)
    p = b
    rel = torch.ones_like(bn)
    it = nrep = nres = 0
    while bool(rel >= tolerance) and it < max_iters and nres <= max_restarts:
        # the replacement sweep enters with rs = +inf: its first pass
        # always refreshes the residual
        rs = torch.full_like(bn, float("inf"))
        while it < max_iters and bool(torch.sqrt(rs) >= thr):
            r = b - spmv(A32, x)
            rs = dot_single(r, r)
            j = 0
            while (j < replace_every and it < max_iters
                   and bool(torch.sqrt(rs) >= thr)):
                Ap = spmv(A16, p)
                pAp = dot_single(p, Ap)
                alpha = torch.where(pAp == 0, zero, rs / pAp)
                x = x + alpha * p
                r = r - alpha * Ap
                rs_new = dot_single(r, r)
                beta = torch.where(rs == 0, zero, rs_new / rs)
                p = r + beta * p
                rs = rs_new
                j += 1
                it += 1
            nrep += 1
        p = b - spmv(A32, x)
        rel = torch.sqrt(dot_single(p, p)) / bn
        nres += 1
    return ReplCgResult(x=x, iterations=it, converged=bool(rel < tolerance),
                        residual=float(rel), replacements=nrep,
                        restarts=nres - 1)


def _refined_f32(A16, A32, b, multi, tolerance, inner_tolerance,
                 inner_max_iters, max_refinements) -> RefineResult:
    dot = dot_multiple if multi else dot_single
    b = b.to(torch.float32)
    bn = torch.sqrt(dot(b, b))
    bn = torch.where(bn == 0, torch.ones_like(bn), bn)
    x = torch.zeros_like(b)
    r = b
    rel = torch.ones((), dtype=torch.float32, device=b.device)
    k = inner = 0
    while k < max_refinements and bool(rel >= tolerance):
        if multi:
            res = cg_solve_multi(A16, r, inner_max_iters, inner_tolerance,
                                 record_history=False)
        else:
            res = cg_solve(A16, r, inner_max_iters, inner_tolerance)
        x = x + res.x
        r = b - (spmm(A32, x) if multi else spmv(A32, x))
        rel = torch.max(torch.sqrt(dot(r, r)) / bn)
        k += 1
        inner += res.iterations
    return RefineResult(x=x, refinements=k, inner_iterations=inner,
                        residual=torch.sqrt(dot(r, r)) / bn)


def cg_solve_refined_f32(A16, A32, b: torch.Tensor, tolerance: float = 1e-5,
                         inner_tolerance: float = 1e-2,
                         inner_max_iters: int = 1000,
                         max_refinements: int = 12, strategy="auto",
                         bake: bool | None = None) -> RefineResult:
    """Single-RHS float32 solve by refinement: inner CG on the
    bf16-plane plan ``A16`` to ``inner_tolerance`` (the bf16 operator is
    accurate to about 4e-3, so a tighter inner solve buys nothing per
    step), exact float32 residuals on ``A32``. ``strategy`` is validated
    only and ``bake`` ignored, as in ``cg_solve``."""
    SpmvStrategy.parse(strategy)
    return _refined_f32(A16, A32, b, False, tolerance, inner_tolerance,
                        inner_max_iters, max_refinements)


def cg_solve_multi_refined_f32(A16, A32, B: torch.Tensor,
                               tolerance: float = 1e-5,
                               inner_tolerance: float = 1e-2,
                               inner_max_iters: int = 1000,
                               max_refinements: int = 12, strategy="auto",
                               bake: bool | None = None) -> RefineResult:
    """Blocked multi-RHS variant of :func:`cg_solve_refined_f32`: B is
    (n, L), and the loop ends on the largest lane's residual."""
    SpmvStrategy.parse(strategy)
    if B.dim() != 2:
        raise ValueError(f"B must be (n, L), got {tuple(B.shape)}")
    return _refined_f32(A16, A32, B, True, tolerance, inner_tolerance,
                        inner_max_iters, max_refinements)


def _solve_refined(A32, A_acc, b, multi, tolerance, inner_tolerance,
                   inner_max_iters, max_refinements) -> RefineResult:
    """The JAX package's ``_solve_refined``: ``rel`` is taken from the
    residual before each step's correction, the loop leaves only when
    it is below ``tolerance`` after at least two steps, and the
    returned residual is recomputed after the last correction."""
    if plan_semantics(A_acc) != "ieee-f64":
        raise TypeError("the residual operator A_acc must be a float64 "
                        f"plan, got {plan_semantics(A_acc)}")
    if plan_semantics(A32) != "f32":
        raise TypeError("the inner operator A32 must be a float32 plan, "
                        f"got {plan_semantics(A32)}")
    dot = dot_multiple if multi else dot_single
    mv = spmm if multi else spmv
    b = b.to(torch.float64)
    bn = torch.sqrt(dot(b, b))
    bn = torch.where(bn == 0, torch.ones_like(bn), bn)
    x = torch.zeros_like(b)
    refinements = inner = 0
    for k in range(max_refinements):
        r = b - mv(A_acc, x)
        r32 = r.to(torch.float32)
        if multi:
            res = cg_solve_multi(A32, r32, inner_max_iters, inner_tolerance,
                                 record_history=False)
        else:
            res = cg_solve(A32, r32, inner_max_iters, inner_tolerance)
        x = x + res.x.to(torch.float64)
        inner += res.iterations
        refinements = k + 1
        rel = torch.sqrt(dot(r, r)) / bn
        if float(torch.max(rel)) < tolerance and k > 0:
            break
    r = b - mv(A_acc, x)
    return RefineResult(x=x, refinements=refinements, inner_iterations=inner,
                        residual=torch.sqrt(dot(r, r)) / bn)


def cg_solve_refined(A32, A_acc, b: torch.Tensor, tolerance: float = 1e-12,
                     inner_tolerance: float = 1e-7,
                     inner_max_iters: int = 10000,
                     max_refinements: int = 8,
                     strategy="auto") -> RefineResult:
    """Single-RHS float64 solve by refinement: inner CG on the float32
    plan ``A32`` to ``inner_tolerance``, float64 residuals on the
    float64 plan ``A_acc`` (``plan_matrix(csr, dtype=np.float64)``),
    ``x`` updated in float64. At least two refinements run.
    ``strategy`` is validated only, as in ``cg_solve``."""
    SpmvStrategy.parse(strategy)
    return _solve_refined(A32, A_acc, b, False, tolerance, inner_tolerance,
                          inner_max_iters, max_refinements)


def cg_solve_multi_refined(A32, A_acc, B: torch.Tensor,
                           tolerance: float = 1e-12,
                           inner_tolerance: float = 1e-7,
                           inner_max_iters: int = 10000,
                           max_refinements: int = 8,
                           strategy="auto") -> RefineResult:
    """Blocked multi-RHS variant of :func:`cg_solve_refined`: B is
    (n, L), the inner solve is ``cg_solve_multi``, and the loop ends on
    the largest lane's residual."""
    SpmvStrategy.parse(strategy)
    if B.dim() != 2:
        raise ValueError(f"B must be (n, L), got {tuple(B.shape)}")
    return _solve_refined(A32, A_acc, B, True, tolerance, inner_tolerance,
                          inner_max_iters, max_refinements)
