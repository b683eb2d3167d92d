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
iteration (the JAX package's ``_pcg_solve_multi_transposed``). The JAX
package's n-major interleaved path waits for kernel B12 (ROADMAP A15).

On a ``ReorderedPlan`` the solve runs in the permuted space, as
``cg_solve_multi`` does: B is permuted once on the way in and X once on
the way out (K6), and the solve runs on the inner plan. The
preconditioner then acts in the plan's order: build it from
``A.permuted(csr)``, the reordered matrix, whose IC(0) factor is the
better one (the JAX package's ``multicg`` bench takes the same steps by
hand; its ``pcg_solve_multi`` would take the dispatch route, with two
permutations per product and the preconditioner in the original order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpusparse_torch.ops.reorder import ReorderedPlan
from tpusparse_torch.ops.spmv import spmm
from tpusparse_torch.solvers.cg import (
    CgResult,
    _cg_multi_loop,
    _dia_t_callable,
)


def pcg_solve_multi(A, B: torch.Tensor, apply_precond: Callable,
                    max_iters: int = 10000, tolerance: float = 1e-5,
                    matmat: Callable | None = None,
                    record_history: bool = True) -> CgResult:
    """Blocked multi-RHS PCG on A X = B for a plan ``A`` of
    ``plan_matrix`` (or ``matmat``, an (n, L) -> (n, L) product), with
    ``apply_precond(R) -> Z`` applying M^{-1} column-wise on (n, L)
    blocks, in the plan's order (``A.permuted(csr)`` for a
    ``ReorderedPlan``)."""
    if B.dim() != 2:
        raise ValueError(f"B must be (n, L), got {tuple(B.shape)}")
    if isinstance(A, ReorderedPlan) and matmat is None:
        res = pcg_solve_multi(A.inner, A.apply_perm(B), apply_precond,
                              max_iters, tolerance, None, record_history)
        return dataclasses.replace(res, x=A.apply_inv(res.x))
    mm_t = _dia_t_callable(A) if matmat is None else None
    if mm_t is not None:
        def apply_t(RT):
            return apply_precond(RT.T.contiguous()).to(B.dtype).T.contiguous()

        XT, i, converged, rel, hist = _cg_multi_loop(
            mm_t, B.T.contiguous(), 0, max_iters, tolerance, record_history,
            apply_t)
        return CgResult(x=XT.T.contiguous(), iterations=i,
                        converged=converged, residual=rel, history=hist)
    mm = matmat if matmat is not None else (lambda V: spmm(A, V))
    X, i, converged, rel, hist = _cg_multi_loop(
        mm, B, 1, max_iters, tolerance, record_history, apply_precond)
    return CgResult(x=X, iterations=i, converged=converged, residual=rel,
                    history=hist)


@dataclasses.dataclass
class Ic0Preconditioner:
    """z = (L L^T)^{-1} r: the backward solve of the forward one, each a
    ``JacobiTriSolver`` or a ``LevelScheduledSolver``; called on (n, L)
    blocks or vectors."""

    fwd: Any
    bwd: Any

    def __call__(self, R: torch.Tensor) -> torch.Tensor:
        return self.bwd.solve(self.fwd.solve(R))


def make_ic0_preconditioner(L_host, sweeps: int = 2, to_plan=None,
                            num_rhs: int = 16, dtype=None, device="cuda"):
    """z = (L L^T)^{-1} r from a host IC(0) factor by device Jacobi
    triangular solves (``sweeps`` of each; exact once ``sweeps`` reaches
    the factor's dependency depth). The truncated composite is symmetric
    positive semi-definite at any sweep count (the backward operator is
    the forward one's transpose), so PCG stays valid. Pass the system's
    ``dtype`` for a float32 solve: the factor is float64, and uncast every
    sweep would run in float64."""
    from tpusparse_torch.precond.trisolve import (
        jacobi_trisolve_lower,
        jacobi_trisolve_upper,
    )

    return Ic0Preconditioner(
        jacobi_trisolve_lower(L_host, sweeps, to_plan, num_rhs, dtype,
                              device),
        jacobi_trisolve_upper(L_host, sweeps, to_plan, num_rhs, dtype,
                              device))


def make_exact_ic0_preconditioner(L_host, device="cuda", impl=None):
    """z = (L L^T)^{-1} r exactly, by level-scheduled triangular solves
    (``precond/trisolve.LevelScheduledSolver``): the reference's exact
    substitution PCG. Each application runs 2 x nlev eager steps."""
    from tpusparse_torch.precond.trisolve import (
        level_trisolve_lower,
        level_trisolve_upper,
    )

    return Ic0Preconditioner(level_trisolve_lower(L_host, device, impl),
                             level_trisolve_upper(L_host, device, impl))
