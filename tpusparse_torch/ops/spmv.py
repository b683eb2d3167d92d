"""Public SpMV / SpMM with strategy planning (port of
``tpusparse/ops/spmv.py``).

``plan_matrix`` builds a device operand for a host CsrMatrix, in
float32 or float64; ``spmv`` (x of shape (num_cols,)) and ``spmm`` (X of
shape (num_cols, L)) dispatch on the operand type and compute in the
plan's type (x is cast to it). The strategies the port runs, at any
L >= 1 and in either type (the float64 kernels K1d-K5d are the IEEE
float64 twins of K1-K5):

  AUTO       — a matrix whose dense diagonals carry at least
               ``DIA_MIN_COVERAGE`` of the nonzeros peels them: a square
               constant-coefficient band of at most 32 diagonals goes to
               the masked DIA kernel (K1, K1d), any other band
               (rectangular, variable coefficients, up to 64 diagonals)
               to the value-plane kernel (K5, K5d); a scattered remainder
               goes to the merge plan. Everything else goes to the merge
               plan.
  DIA        — the same peel without the coverage gate.
  MERGE      — the merge plan on the whole matrix: K2 (K2d) for SpMV, K3
               (K3d) for SpMM.
  ROW_SPLIT  — (aliases 'ell', 'simple') the row-split kernel K4 (K4d),
               for SpMV and SpMM; never an AUTO choice.
  REFERENCE  — the plain-torch golden product on ``csr.to(device,
               dtype)``.

A float64 plan is strict IEEE float64 (``plan_semantics`` 'ieee-f64'),
held to the JAX package's ``strategy='reference'`` float64 path. The
JAX package's float64 AUTO plans are double-float (two-f32) kernels,
which exist because the TPU has no 64-bit types, and the gates that
pick them (``DIA_STREAM_F64_MIN_BYTES``, ``DF_ELL_MIN_OCC``, the VMEM
size limits) follow TPU VMEM and XLA fusion; none is ported.

``plan_dia_bf16`` builds the opt-in bf16-plane operator of the
mixed-precision solvers (``solvers/refine.py``); AUTO never does.

The plan may differ from the JAX package's plan; the numbers may not.
The JAX planner's ELL-occupancy gate between its merge and gather-job
kernels measures TPU lane packing and is not ported: a gate between K3
and K4 waits for measurements on the card. Nor are its gates between
the XLA DIA op and the stream kernels (``DIA_STREAM_MIN_BYTES``,
``DIA_STREAM_MAX_L``, ``stream_ok`` and the ``fits_stream`` block limit
on |offset|): they follow XLA's fusion capacity and the TPU's VMEM
blocks, and one Hopper kernel (K5) covers both regimes. The other
strategies and reordering raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import enum
import warnings

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix, value_dtype
from tpusparse_torch.formats.dia import (
    DiaDevice,
    diagonal_profile,
    partition_dia,
    select_diagonals,
    to_device_dia,
)
from tpusparse_torch.kernels.dia_stream import (
    DiaStreamDevice,
    _maskable,
    spmm_dia_stream,
    spmv_dia_stream,
    to_device_dia_stream,
)
from tpusparse_torch.kernels.ell_spmm import (
    RowSplitDevice,
    spmm_ell,
    spmv_ell,
    to_device_row_split,
)
from tpusparse_torch.kernels.merge_spmv import (
    MergeDevice,
    spmv_merge,
    to_device_merge,
)
from tpusparse_torch.kernels.spmm_merge import spmm_merge
from tpusparse_torch.ops.dia import spmm_dia, spmv_dia
from tpusparse_torch.ops.hybrid import HybridPlan, spmm_hybrid, spmv_hybrid
from tpusparse_torch.ops.reference import spmm_reference, spmv_reference


class SpmvStrategy(enum.Enum):
    REFERENCE = "reference"
    MERGE = "merge"
    NONZERO_SPLIT = "nonzero_split"
    ROW_SPLIT = "row_split"
    BSR = "bsr"
    BCOO = "bcoo"
    DIA = "dia"
    NMAJOR = "nmajor"
    AUTO = "auto"

    @classmethod
    def parse(cls, s) -> "SpmvStrategy":
        if isinstance(s, cls):
            return s
        aliases = {"simple": "row_split", "ell": "row_split",
                   "hybrid": "dia", "mkl": "bcoo"}
        s = str(s).lower()
        return cls(aliases.get(s, s))


# Where each strategy the port does not run yet is planned (ROADMAP.md).
_NOT_PORTED = {
    SpmvStrategy.NONZERO_SPLIT: "the nonzero_split strategy row (ROADMAP A14)",
    SpmvStrategy.BSR: "BCSR panel SpMM, kernel B6 (ROADMAP A8b)",
    SpmvStrategy.BCOO: "the vendor-baseline row (ROADMAP A6)",
    SpmvStrategy.NMAJOR: "n-major masked multi-RHS DIA, kernel B12 "
                         "(ROADMAP A15)",
}

# AUTO peels diagonals only when the selected ones carry at least this
# fraction of the nonzeros (the JAX package's gate).
DIA_MIN_COVERAGE = 0.3


def plan_matrix(csr: CsrMatrix, strategy="auto", dtype=np.float32,
                L: int = 1, device="cuda", reorder=None):
    """Build the device operand of a host CsrMatrix on ``device``, its
    values in ``dtype`` (numpy or torch float32 or float64; float64
    keeps the host values unrounded). ``L`` (>= 1) is the number of
    right-hand sides the plan will serve; every plan of the port serves
    any L, so it does not change the choice."""
    if reorder:
        raise NotImplementedError(
            "reorder: reordered plans (kernel B13) are ROADMAP A10")
    strategy = SpmvStrategy.parse(strategy)
    dtype = value_dtype(dtype)
    if int(L) < 1:
        raise ValueError(f"L={L}: the number of right-hand sides is >= 1")
    if strategy in _NOT_PORTED:
        raise NotImplementedError(
            f"strategy '{strategy.value}': {_NOT_PORTED[strategy]}")
    if strategy == SpmvStrategy.REFERENCE:
        return csr.to(device, dtype)
    if strategy == SpmvStrategy.ROW_SPLIT:
        return to_device_row_split(csr, device, dtype)
    if strategy in (SpmvStrategy.AUTO, SpmvStrategy.DIA):
        plan = _try_plan_dia(csr, strategy, device, dtype)
        if plan is not None:
            return plan
    return to_device_merge(csr, device, dtype)


def _try_plan_dia(csr: CsrMatrix, strategy: SpmvStrategy, device, dtype):
    """DIA / hybrid plan in ``dtype``, or None when the matrix has no
    diagonal structure worth peeling (explicit 'dia' skips the coverage
    gate). A square constant-coefficient band is masked (K1, K1d); any
    other band keeps its value planes (K5, K5d)."""
    if csr.nnz == 0:
        return None
    offsets = select_diagonals(csr)
    if offsets.size == 0:
        return None
    all_off, counts, _ = diagonal_profile(csr)
    covered = int(counts[np.isin(all_off, offsets)].sum())
    if (strategy != SpmvStrategy.DIA
            and covered < DIA_MIN_COVERAGE * csr.nnz):
        return None
    dia_host, rest = partition_dia(csr, offsets)
    if csr.num_rows == csr.num_cols and _maskable(dia_host)[1]:
        dev = to_device_dia_stream(dia_host, device, dtype)
    else:
        dev = to_device_dia(dia_host, device, plane_dtype=dtype)
    rest_plan = (to_device_merge(rest, device, dtype) if rest.nnz > 0
                 else None)
    return HybridPlan(dev, rest_plan, csr.nnz)


def plan_dia_bf16(csr: CsrMatrix, L: int = 1, device="cuda") -> HybridPlan:
    """Opt-in bf16-plane plan: the inner operator of the mixed-precision
    solvers (``solvers/refine.py``), never an AUTO choice. The planes
    are stored bf16, which perturbs the operator by about 4e-3 relative
    (bf16 eps = 2^-8); K5 upcasts them in-register and computes in
    float32. The scattered remainder, if any, stays an exact float32
    merge plan. ``L`` (>= 1) does not change the plan.

    Raises ValueError for a matrix that is not square or has no dense
    diagonals. The JAX package's refusal of a band wider than its stream
    block (``fits_stream``) has no counterpart: K5 has no limit on
    |offset|."""
    if int(L) < 1:
        raise ValueError(f"L={L}: the number of right-hand sides is >= 1")
    if csr.num_rows != csr.num_cols:
        raise ValueError("plan_dia_bf16: square matrices only")
    offsets = select_diagonals(csr)
    if offsets.size == 0:
        raise ValueError(
            "plan_dia_bf16: no dense diagonals selected — the bf16-plane "
            "plan needs a diagonal-structured operator")
    dia_host, rest = partition_dia(csr, offsets)
    if _maskable(dia_host)[1]:
        warnings.warn(
            "plan_dia_bf16: the operator is constant-coefficient — the "
            "exact masked plan (strategy='dia') reads 4 B/row and beats "
            "bf16 value planes; proceeding as requested", stacklevel=2)
    dev = to_device_dia(dia_host, device, plane_dtype=torch.bfloat16)
    rest_plan = to_device_merge(rest, device) if rest.nnz > 0 else None
    return HybridPlan(dev, rest_plan, csr.nnz)


def plan_dtype(A) -> torch.dtype:
    """The stored value type of a plan: float32 or float64, or bf16 for
    bf16 value planes (a hybrid takes it from its DIA part, whose
    remainder then holds float32)."""
    plan_kind(A)
    if isinstance(A, HybridPlan):
        A = A.dia
    if isinstance(A, DiaStreamDevice):
        return A.vals.dtype
    if isinstance(A, DiaDevice):
        return A.data.dtype
    return A.values.dtype


def _bf16_planes(A) -> bool:
    return isinstance(A, DiaDevice) and A.data.dtype == torch.bfloat16


def plan_kind(A) -> str:
    """Short name of a plan's kernel family (the JAX package's labels)."""
    if isinstance(A, HybridPlan):
        tag = "dia_bf16" if _bf16_planes(A.dia) else "dia"
        return tag if A.rest is None else "hybrid_" + tag
    if isinstance(A, (DiaStreamDevice, DiaDevice)):
        return "dia_bf16" if _bf16_planes(A) else "dia"
    if isinstance(A, MergeDevice):
        return "merge"
    if isinstance(A, RowSplitDevice):
        return "row_split"
    if isinstance(A, CsrMatrix):
        return "reference"
    raise TypeError(f"not a plan: {type(A).__name__}")


def plan_semantics(A) -> str:
    """Numeric semantics a plan's kernels deliver, with the JAX
    package's labels: ``'ieee-f64'`` for a float64 plan (strict IEEE
    float64, every kernel K1d-K5d and the reference product),
    ``'bf16-plane(~4e-3)'`` for bf16 value planes (a hybrid takes it
    from its DIA part, as in the JAX package), else ``'f32'``. The
    JAX package's ``'double-float(~1e-14)'`` plans have no counterpart."""
    return {torch.float64: "ieee-f64",
            torch.bfloat16: "bf16-plane(~4e-3)"}.get(plan_dtype(A), "f32")


def spmv(A, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y for any plan of ``plan_matrix``."""
    if isinstance(A, HybridPlan):
        return spmv_hybrid(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, DiaStreamDevice):
        return spmv_dia_stream(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, DiaDevice):
        return spmv_dia(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, MergeDevice):
        return spmv_merge(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, RowSplitDevice):
        return spmv_ell(A, x, alpha=alpha, beta=beta, y=y)
    if isinstance(A, CsrMatrix):
        return spmv_reference(A, x, alpha=alpha, beta=beta, y=y)
    raise TypeError(f"not a plan: {type(A).__name__}")


def spmm(A, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y for any plan of ``plan_matrix``, X
    of shape (num_cols, L); a 1-D X (and Y) is taken as L = 1 and the
    result is 1-D."""
    if X.dim() == 1:
        Y2 = None if Y is None else Y.reshape(-1, 1)
        return spmm(A, X.reshape(-1, 1), alpha=alpha, beta=beta, Y=Y2)[:, 0]
    if isinstance(A, HybridPlan):
        return spmm_hybrid(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, DiaStreamDevice):
        return spmm_dia_stream(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, DiaDevice):
        return spmm_dia(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, MergeDevice):
        return spmm_merge(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, RowSplitDevice):
        return spmm_ell(A, X, alpha=alpha, beta=beta, Y=Y)
    if isinstance(A, CsrMatrix):
        return spmm_reference(A, X, alpha=alpha, beta=beta, Y=Y)
    raise TypeError(f"not a plan: {type(A).__name__}")
