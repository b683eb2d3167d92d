"""PCG: preconditioned conjugate gradient with IC(0) (port of
``tpusparse/solvers/pcg.py``).

The reference's ``PCGSolveMultiple``: blocked CG on B (n, L) with
z = M^{-1} r applied every iteration and the recurrences on rho = r.z,
with the JAX package's semantics (``pcg_solve_multi``):

  * Z is cast back to B's type (an IC(0) factor is float64);
  * per-lane masks: alpha = 0 where a lane has converged or p.Ap == 0,
    beta = 0 where it has converged or rho was 0;
  * ``converged`` is updated after each iteration's body, the loop runs
    while some lane has not converged, and the history holds the largest
    relative residual over the lanes.

The loop is the one of ``cg_solve_multi`` (``solvers/cg._cg_multi_loop``)
with a preconditioner: eager, one host sync per iteration. A pure DIA
plan keeps its state in (L, n), the kernels' layout, and the
preconditioner keeps its (n, L) contract behind two transposes per
iteration (the JAX package's ``_pcg_solve_multi_transposed``). A pure
n-major plan with float32 B of at most its ``L`` columns keeps (n, L)
state on K7, and the preconditioner takes it with no transposes (the
function of the JAX package's ``_pcg_solve_multi_interleaved``).

A preconditioner is in the caller's order, as in the JAX package. On a
``ReorderedPlan`` the solve runs in the permuted space all the same (B
permuted once on the way in and X once on the way out, by K6, the inner
plan in between), and the preconditioner runs behind K6: each residual
is permuted back to the caller's order, preconditioned, and permuted
again (``apply_inv`` in, ``apply_perm`` out). The iterations are the
JAX package's, whose PCG permutes around each product instead. A
preconditioner built from ``A.permuted(csr)`` (the reordered matrix,
whose IC(0) factor is the better one) declares it with ``perm=A.perm``
(``pcg_solve_multi(..., perm=A.perm)``, ``make_ic0_preconditioner(...,
perm=A.perm)``, ``spai_cg_solve_multi(..., perm=A.perm)``) and is
applied to the permuted residuals directly. A
declared ``perm`` that is not the plan's raises ValueError; so does one
on a solve that does not run in the permuted space (a plan that is not
reordered, or a ``matmat``, which takes the JAX route: the caller's
product, no permuted-space solve).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpusparse_torch.ops.reorder import ReorderedPlan
from tpusparse_torch.ops.spmv import SpmvStrategy
from tpusparse_torch.solvers.cg import CgResult, _block_product, _cg_multi_loop


def _same_order(perm, plan_perm: torch.Tensor) -> bool:
    """Whether a declared permutation (tensor or array) is the plan's."""
    if perm is plan_perm:
        return True
    p = torch.as_tensor(perm).reshape(-1)
    return p.shape == plan_perm.shape and torch.equal(
        p.to(plan_perm.device, plan_perm.dtype), plan_perm)


def pcg_solve_multi(A, B: torch.Tensor, apply_precond: Callable,
                    max_iters: int = 10000, tolerance: float = 1e-5,
                    strategy="auto", matmat: Callable | None = None,
                    record_history: bool = True, *, perm=None) -> CgResult:
    """Blocked multi-RHS PCG on A X = B for a plan ``A`` of
    ``plan_matrix`` (or ``matmat``, an (n, L) -> (n, L) product), with
    ``apply_precond(R) -> Z`` applying M^{-1} column-wise on (n, L)
    blocks, in the caller's order unless ``perm`` declares the plan's
    (see the module docstring). ``perm`` defaults to
    ``apply_precond.perm`` where it has one (``Ic0Preconditioner``).
    The positional arguments are the JAX package's; ``strategy`` is
    validated only, as in ``cg_solve``."""
    if B.dim() != 2:
        raise ValueError(f"B must be (n, L), got {tuple(B.shape)}")
    SpmvStrategy.parse(strategy)
    if perm is None:
        perm = getattr(apply_precond, "perm", None)
    if isinstance(A, ReorderedPlan) and matmat is None:
        if perm is None:
            def prec(R):
                return A.apply_perm(apply_precond(A.apply_inv(R)))
        elif _same_order(perm, A.perm):
            def prec(R):
                return apply_precond(R)
        else:
            raise ValueError("the preconditioner declares another order "
                             "than the plan's (perm is not A.perm)")
        res = pcg_solve_multi(A.inner, A.apply_perm(B), prec, max_iters,
                              tolerance, record_history=record_history)
        return dataclasses.replace(res, x=A.apply_inv(res.x))
    if perm is not None:
        raise ValueError(
            "the preconditioner declares a plan order (perm), but this "
            "solve does not run in a reordered plan's permuted space")
    lane_dim, prec = 1, apply_precond
    if matmat is None:
        matmat, lane_dim = _block_product(A, B)
    if lane_dim == 0:
        def prec(RT):
            return apply_precond(RT.T.contiguous()).to(B.dtype).T.contiguous()

    X, i, converged, rel, hist = _cg_multi_loop(
        matmat, B, lane_dim, max_iters, tolerance, record_history, prec)
    return CgResult(x=X, iterations=i, converged=converged, residual=rel,
                    history=hist)


@dataclasses.dataclass
class Ic0Preconditioner:
    """z = (L L^T)^{-1} r: the backward solve of the forward one, each a
    ``JacobiTriSolver`` or a ``LevelScheduledSolver``; called on (n, L)
    blocks or vectors. ``perm``: None for a factor of the matrix in the
    caller's order, or the ``ReorderedPlan``'s ``perm`` for a factor of
    ``A.permuted(csr)``."""

    fwd: Any
    bwd: Any
    perm: Any = None

    def __call__(self, R: torch.Tensor) -> torch.Tensor:
        return self.bwd.solve(self.fwd.solve(R))


def make_ic0_preconditioner(L_host, sweeps: int = 2, to_plan=None,
                            num_rhs: int = 16, dtype=None, device="cuda",
                            perm=None):
    """z = (L L^T)^{-1} r from a host IC(0) factor by device Jacobi
    triangular solves (``sweeps`` of each; exact once ``sweeps`` reaches
    the factor's dependency depth). The truncated composite is symmetric
    positive semi-definite at any sweep count (the backward operator is
    the forward one's transpose), so PCG stays valid. Pass the system's
    ``dtype`` for a float32 solve: the factor is float64, and uncast every
    sweep would run in float64. Pass ``perm=A.perm`` for the factor of a
    ``ReorderedPlan``'s ``A.permuted(csr)``."""
    from tpusparse_torch.precond.trisolve import (
        jacobi_trisolve_lower,
        jacobi_trisolve_upper,
    )

    return Ic0Preconditioner(
        jacobi_trisolve_lower(L_host, sweeps, to_plan, num_rhs, dtype,
                              device),
        jacobi_trisolve_upper(L_host, sweeps, to_plan, num_rhs, dtype,
                              device), perm)


def make_exact_ic0_preconditioner(L_host, device="cuda", impl=None,
                                  perm=None):
    """z = (L L^T)^{-1} r exactly, by level-scheduled triangular solves
    (``precond/trisolve.LevelScheduledSolver``): the reference's exact
    substitution PCG. Each application runs 2 x nlev eager steps.
    ``perm`` as for ``make_ic0_preconditioner``."""
    from tpusparse_torch.precond.trisolve import (
        level_trisolve_lower,
        level_trisolve_upper,
    )

    return Ic0Preconditioner(level_trisolve_lower(L_host, device, impl),
                             level_trisolve_upper(L_host, device, impl), perm)
