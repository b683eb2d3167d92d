"""tpusparse_torch — the PyTorch/CUDA port of ``tpusparse``.

The JAX package ``tpusparse`` stays beside this one as the reference
each part of the port is held against. This package imports ``torch``,
numpy and scipy, and never ``jax`` or ``tpusparse``: it carries its own
numpy host layer.

Layering mirrors ``tpusparse``:

    formats/   COO, host CSR (+ ``to(device)``), DIA partition (numpy)
    io/        .mtx reader, synthetic generators (numpy)
    ops/       plan_matrix / spmv / spmm dispatch, hybrid DIA + merge,
               BLAS-1 (single and multi-RHS)
    kernels/   hand-written CUDA kernels (``csrc/``) and their plain
               PyTorch versions, which serve CPU tensors only
    solvers/   conjugate gradient, single and blocked multi-RHS; the
               float64 refinements and the bf16-plane mixed-precision
               solvers
    bench/     CUDA-event timing, flop and byte models
    utils/     result comparison, carrying JAX plans across

The main paths are host ingest -> ``plan_matrix(csr, "auto",
device=...)`` -> ``spmv`` / ``cg_solve`` (one right-hand side) and ->
``spmm`` / ``cg_solve_multi`` (X and B of shape (n, L)), in float32 or,
with ``dtype=np.float64``, in IEEE float64; float64 solutions at float32
speed through ``cg_solve_refined`` / ``cg_solve_multi_refined`` (a
float32 and a float64 plan of one matrix); for a variable-coefficient
band also ``plan_dia_bf16`` -> ``cg_solve_bf16`` /
``cg_solve_refined_f32`` / ``cg_solve_multi_refined_f32``.
"""

__version__ = "0.4.0"

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
from tpusparse_torch.solvers.cg import CgResult, cg_solve, cg_solve_multi
from tpusparse_torch.solvers.refine import (
    RefineResult,
    ReplCgResult,
    cg_solve_bf16,
    cg_solve_multi_refined,
    cg_solve_multi_refined_f32,
    cg_solve_refined,
    cg_solve_refined_f32,
)

__all__ = [
    "CgResult",
    "CooMatrix",
    "CsrMatrix",
    "RefineResult",
    "ReplCgResult",
    "SpmvStrategy",
    "cg_solve",
    "cg_solve_bf16",
    "cg_solve_multi",
    "cg_solve_multi_refined",
    "cg_solve_multi_refined_f32",
    "cg_solve_refined",
    "cg_solve_refined_f32",
    "plan_dia_bf16",
    "plan_dtype",
    "plan_kind",
    "plan_matrix",
    "plan_semantics",
    "read_market",
    "spmm",
    "spmv",
]
