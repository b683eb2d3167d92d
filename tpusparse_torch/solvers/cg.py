"""Single-RHS conjugate gradient (port of ``tpusparse/solvers/cg.py``).

Textbook CG from x0 = 0 with the JAX package's semantics
(``_cg_solve_impl``):

  * the convergence test ``sqrt(r.r) >= ||b|| * tolerance`` comes
    before each iteration's body, so a zero or already-small b takes
    no iteration;
  * ``||b|| == 0`` is replaced by 1;
  * ``alpha = 0`` when ``p.Ap == 0`` and ``beta = 0`` when ``r.r`` was
    exactly 0, so the state never turns NaN;
  * the history holds ``sqrt(r.r) / ||b||`` per iteration, NaN past the
    last one.

The loop is eager: every iteration runs the plan's SpMV kernel and
BLAS-1 on the device and makes one host sync, to read the convergence
test. The JAX package's plan baking and its XLA matvec swap are an
XLA-TPU workaround and have no counterpart. CUDA graphs over blocks of
iterations are later work (ROADMAP A7b).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.ops.blas import axpy_single, dot_single, update_p_single
from tpusparse_torch.ops.spmv import spmv


@dataclasses.dataclass
class CgResult:
    x: torch.Tensor          # solution (n,)
    iterations: int          # iterations executed
    converged: bool
    residual: float          # final relative residual sqrt(r.r) / ||b||
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
