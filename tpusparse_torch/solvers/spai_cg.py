"""SPAI-CG: CG preconditioned by a sparse approximate inverse (port of
``tpusparse/solvers/spai_cg.py``).

The reference's ``SPAISolveMultiple``: PCG whose preconditioner is one
SpMM with the SPAI matrix M (``precond/spai.spai_inverse``), planned by
``plan_matrix`` like any operator, so z = M r runs on the port's
kernels.
"""

from __future__ import annotations

import torch

from tpusparse_torch.ops.spmv import spmm
from tpusparse_torch.solvers.cg import CgResult
from tpusparse_torch.solvers.pcg import pcg_solve_multi


def spai_cg_solve_multi(A, M, B: torch.Tensor, max_iters: int = 10000,
                        tolerance: float = 1e-5, strategy="auto",
                        record_history: bool = True, *,
                        perm=None) -> CgResult:
    """Blocked multi-RHS CG on A X = B with z = M r, for plans ``A`` and
    ``M`` of ``plan_matrix``. M is in the caller's order, as in the JAX
    package; for a ``ReorderedPlan`` A whose M is the SPAI of
    ``A.permuted(csr)``, pass ``perm=A.perm`` (``pcg_solve_multi``).
    ``strategy`` is validated only, as in ``cg_solve``."""
    return pcg_solve_multi(A, B, lambda R: spmm(M, R, strategy=strategy),
                           max_iters, tolerance, strategy,
                           record_history=record_history, perm=perm)
