"""tpusparse_torch — the PyTorch/CUDA port of ``tpusparse``.

The JAX package ``tpusparse`` stays beside this one as the reference
each part of the port is held against. This package imports ``torch``,
numpy and scipy, and never ``jax`` or ``tpusparse``: it carries its own
numpy host layer.

Layering mirrors ``tpusparse``:

    formats/   COO, host CSR (+ ``to(device)``), BCSR, DIA partition
               (numpy)
    io/        .mtx reader, synthetic generators (numpy)
    ops/       plan_matrix / spmv / spmm dispatch, hybrid DIA + merge,
               reordering (RCM, degree; ``ReorderedPlan``), BLAS-1
               (single and multi-RHS)
    kernels/   hand-written CUDA kernels (``csrc/``) and their plain
               PyTorch versions, which serve CPU tensors only
    precond/   IC(0) (host factorization, Jacobi and level-scheduled
               triangular solves) and SPAI
    solvers/   conjugate gradient, single and blocked multi-RHS; PCG with
               IC(0) and SPAI-CG; the float64 refinements and the
               bf16-plane mixed-precision solvers
    bench/     CUDA-event timing, flop and byte models
    utils/     result comparison, carrying JAX plans across

The main paths are host ingest -> ``plan_matrix(csr, "auto",
device=...)`` -> ``spmv`` / ``cg_solve`` (one right-hand side) and ->
``spmm`` / ``cg_solve_multi`` (X and B of shape (n, L)), in float32 or,
with ``dtype=np.float64``, in IEEE float64; float64 solutions at float32
speed through ``cg_solve_refined`` / ``cg_solve_multi_refined`` (a
float32 and a float64 plan of one matrix); for a variable-coefficient
band also ``plan_dia_bf16`` -> ``cg_solve_bf16`` /
``cg_solve_refined_f32`` / ``cg_solve_multi_refined_f32``. With
``plan_matrix(..., reorder='auto' | 'rcm' | 'degree')`` each runs on a
``ReorderedPlan`` (permutations on the card by K6); and
``ic0_factorize`` / ``spai_inverse`` -> ``pcg_solve_multi`` with
``make_ic0_preconditioner`` / ``make_exact_ic0_preconditioner``, and
``spai_cg_solve_multi`` (a preconditioner in the caller's order, or in a
reordered plan's order when it declares ``perm=A.perm``). Two explicit
strategies serve (n, L) blocks: ``plan_matrix(csr, 'nmajor', L=L)`` (K7,
no transposes; ``cg_solve_multi`` / ``pcg_solve_multi`` keep (n, L)
state on it) and ``plan_matrix(csr, 'bsr')`` (``BcsrMatrix`` blocks on
K8, K8d in float64).
"""

__version__ = "0.6.0"

from tpusparse_torch.formats.bcsr import BcsrMatrix
from tpusparse_torch.formats.coo import CooMatrix
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.io.market import read_market
from tpusparse_torch.ops.spmv import (
    SpmvStrategy,
    plan_dia_bf16,
    plan_dtype,
    plan_kind,
    plan_matrix,
    plan_semantics,
    spmm,
    spmv,
)
from tpusparse_torch.ops.reorder import ReorderedPlan, plan_reorder
from tpusparse_torch.precond.ic0 import ic0_factorize
from tpusparse_torch.precond.spai import spai_inverse
from tpusparse_torch.solvers.cg import CgResult, cg_solve, cg_solve_multi
from tpusparse_torch.solvers.pcg import (
    make_exact_ic0_preconditioner,
    make_ic0_preconditioner,
    pcg_solve_multi,
)
from tpusparse_torch.solvers.refine import (
    RefineResult,
    ReplCgResult,
    cg_solve_bf16,
    cg_solve_multi_refined,
    cg_solve_multi_refined_f32,
    cg_solve_refined,
    cg_solve_refined_f32,
)
from tpusparse_torch.solvers.spai_cg import spai_cg_solve_multi

__all__ = [
    "BcsrMatrix",
    "CgResult",
    "CooMatrix",
    "CsrMatrix",
    "RefineResult",
    "ReorderedPlan",
    "ReplCgResult",
    "SpmvStrategy",
    "cg_solve",
    "cg_solve_bf16",
    "cg_solve_multi",
    "cg_solve_multi_refined",
    "cg_solve_multi_refined_f32",
    "cg_solve_refined",
    "cg_solve_refined_f32",
    "ic0_factorize",
    "make_exact_ic0_preconditioner",
    "make_ic0_preconditioner",
    "pcg_solve_multi",
    "plan_dia_bf16",
    "plan_dtype",
    "plan_kind",
    "plan_matrix",
    "plan_reorder",
    "plan_semantics",
    "read_market",
    "spai_cg_solve_multi",
    "spai_inverse",
    "spmm",
    "spmv",
]
