"""Public SpMV / SpMM with strategy planning (port of
``tpusparse/ops/spmv.py``).

``plan_matrix`` builds a device operand for a host CsrMatrix, in
float32 or float64; ``spmv`` (x of shape (num_cols,)) and ``spmm`` (X of
shape (num_cols, L)) dispatch on the operand type and compute in the
plan's type (x is cast to it). This module makes every routing decision
of a product: one table (``_OPERANDS``) gives each operand type its
label, its value type and its unscaled vector and block products, a
hybrid or reordered plan composed from its parts' entries; ``spmv`` and
``spmm`` apply alpha and beta once (``_scaled``); ``block_product``
gives the blocked solvers their product and state layout. The kernel
modules below choose nothing. The strategies the port runs, at any
L >= 1 and in either type (the float64 kernels K1d-K5d are the IEEE
float64 twins of K1-K5):

  AUTO       — a matrix whose dense diagonals carry at least
               ``DIA_MIN_COVERAGE`` of the nonzeros peels them: a square
               constant-coefficient band of at most 32 diagonals goes to
               the masked DIA kernel (K1, K1d; ``spmm`` of a row-major
               float32 X of 2 to 128 columns runs K7 on the same band),
               any other band (rectangular, variable coefficients, up to
               64 diagonals) to the value-plane kernel (K5, K5d); a
               scattered remainder goes to the merge plan. Everything
               else goes to the merge plan.
  DIA        — the same peel without the coverage gate.
  MERGE      — the merge plan on the whole matrix: K2 (K2d) for SpMV, K3
               (K3d) for SpMM.
  ROW_SPLIT  — (aliases 'ell', 'simple') the row-split kernel K4 (K4d),
               for SpMV and SpMM; never an AUTO choice.
  NMAJOR     — float32, L >= 2: the masked band on the n-major kernel K7,
               X and Y in (n, L) with no transposes; a scattered
               remainder goes to the merge plan. Never an AUTO choice (as
               in the JAX package).
  BSR        — (8, 128) blocks on the BCSR panel kernel K8 (K8d in
               float64); never an AUTO choice yet: the JAX package's fill
               gate (``fill_estimate >= 0.3``) waits for a card A/B
               against K3.
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
strategies raise ``NotImplementedError`` naming the ROADMAP item that
brings them. A float64 ``bsr`` plan runs K8d where the JAX package plans
``reference``: the plan differs, the numbers do not.

``reorder='rcm' | 'degree' | 'auto'`` plans the symmetrically permuted
matrix and wraps it in a ``ReorderedPlan`` (``ops/reorder.py``); its
permutations run on K6.
"""

from __future__ import annotations

import enum
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpusparse_torch.formats.bcsr import BcsrMatrix
from tpusparse_torch.formats.csr import (
    CsrMatrix,
    host_value_dtype,
    value_dtype,
)
from tpusparse_torch.formats.dia import (
    DiaDevice,
    diagonal_profile,
    partition_dia,
    select_diagonals,
    to_device_dia,
)
from tpusparse_torch.kernels.bsr import bsr_matmat
from tpusparse_torch.kernels.dia_nmajor import (
    LANE_COUNTS,
    DiaNMajorDevice,
    nmajor_matmat,
    to_device_dia_nmajor,
)
from tpusparse_torch.kernels.dia_stream import (
    DiaStreamDevice,
    _maskable,
    planes_value_dtype,
    spmm_dia_planes_t,
    spmm_dia_stream_t,
    to_device_dia_stream,
)
from tpusparse_torch.kernels.ell_spmm import (
    RowSplitDevice,
    row_split_matmat,
    to_device_row_split,
)
from tpusparse_torch.kernels.merge_spmv import (
    MergeDevice,
    merge_matvec,
    to_device_merge,
)
from tpusparse_torch.kernels.spmm_merge import merge_matmat
from tpusparse_torch.ops.hybrid import HybridPlan
from tpusparse_torch.ops.reference import csr_matmat, csr_matvec
from tpusparse_torch.ops.reorder import ReorderedPlan
from tpusparse_torch.utils import trace


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
    SpmvStrategy.NONZERO_SPLIT: "the nonzero_split strategy row (ROADMAP A19)",
    SpmvStrategy.BCOO: "the vendor-baseline row (ROADMAP A6)",
}

# AUTO peels diagonals only when the selected ones carry at least this
# fraction of the nonzeros (the JAX package's gate).
DIA_MIN_COVERAGE = 0.3

# The blocks of a 'bsr' plan (the JAX package's).
BSR_BLOCK = (8, 128)


def plan_matrix(csr: CsrMatrix, strategy="auto", dtype=None,
                L: int = 1, device="cuda", reorder=None):
    """Build the device operand of a host CsrMatrix on ``device``, its
    values in ``dtype`` (numpy or torch float32 or float64; float64
    keeps the host values unrounded; None, the default, takes the host
    values' type, as the JAX package does: pass ``dtype=np.float32``
    for a float32 plan of float64 values). ``L`` (>= 1) is the number of
    right-hand sides the plan will serve; it does not change the choice,
    and every plan serves any L but the n-major one, which serves up to
    the JAX package's padded lane count for L. ``reorder`` ('rcm',
    'degree' or 'auto') plans a symmetric permutation of the matrix
    (``ops/reorder.plan_reorder``)."""
    with trace.span("plan_matrix"):
        if reorder:
            from tpusparse_torch.ops.reorder import plan_reorder

            return plan_reorder(csr, strategy=strategy, dtype=dtype, L=L,
                                order=reorder, device=device)
        strategy = SpmvStrategy.parse(strategy)
        dtype = value_dtype(host_value_dtype(csr) if dtype is None
                            else dtype)
        if int(L) < 1:
            raise ValueError(
                f"L={L}: the number of right-hand sides is >= 1")
        if strategy in _NOT_PORTED:
            raise NotImplementedError(
                f"strategy '{strategy.value}': {_NOT_PORTED[strategy]}")
        if strategy == SpmvStrategy.NMAJOR:
            return _plan_nmajor(csr, int(L), device, dtype)
        if strategy in (SpmvStrategy.AUTO, SpmvStrategy.DIA):
            plan = _try_plan_dia(csr, strategy, device, dtype)
            if plan is not None:
                return plan
        with trace.span("plan.operand"):
            if strategy == SpmvStrategy.REFERENCE:
                return csr.to(device, dtype)
            if strategy == SpmvStrategy.ROW_SPLIT:
                return to_device_row_split(csr, device, dtype)
            if strategy == SpmvStrategy.BSR:
                return BcsrMatrix.from_csr(csr, *BSR_BLOCK).to(device,
                                                               dtype)
            return to_device_merge(csr, device, dtype)


def _try_plan_dia(csr: CsrMatrix, strategy: SpmvStrategy, device, dtype):
    """DIA / hybrid plan in ``dtype``, or None when the matrix has no
    diagonal structure worth peeling (explicit 'dia' skips the coverage
    gate). A square constant-coefficient band is masked (K1, K1d); any
    other band keeps its value planes (K5, K5d)."""
    if csr.nnz == 0:
        return None
    with trace.span("plan.select"):
        offsets = select_diagonals(csr)
        if offsets.size == 0:
            return None
        all_off, counts, _ = diagonal_profile(csr)
        covered = int(counts[np.isin(all_off, offsets)].sum())
        if (strategy != SpmvStrategy.DIA
                and covered < DIA_MIN_COVERAGE * csr.nnz):
            return None
    with trace.span("plan.partition"):
        dia_host, rest = partition_dia(csr, offsets)
        masked = csr.num_rows == csr.num_cols and _maskable(dia_host)[1]
    with trace.span("plan.operand"):
        if masked:
            dev = to_device_dia_stream(dia_host, device, dtype)
        else:
            dev = to_device_dia(dia_host, device, plane_dtype=dtype)
        rest_plan = (to_device_merge(rest, device, dtype) if rest.nnz > 0
                     else None)
    return HybridPlan(dev, rest_plan, csr.nnz)


def _plan_nmajor(csr: CsrMatrix, L: int, device, dtype) -> HybridPlan:
    """The explicit n-major plan: the masked band on K7 for up to L
    right-hand sides, a scattered remainder on the merge plan. Raises
    ValueError where the JAX package does: L < 2, no nonzeros, no
    selected diagonals, float64, a band that is not square and
    constant-coefficient, L > 128. Its VMEM halo gate
    (``plan_geometry``) has no counterpart: K7 takes any offsets, and a
    diagonal-only band too."""
    if L < 2:
        raise ValueError(
            "strategy='nmajor' is a multi-RHS plan (needs L >= 2); use "
            "strategy='dia' for single-RHS masked streams")
    if csr.nnz == 0:
        raise ValueError("strategy='nmajor': matrix has no nonzeros")
    with trace.span("plan.select"):
        offsets = select_diagonals(csr)
    if offsets.size == 0:
        raise ValueError(
            "strategy='nmajor': no dense diagonals selected "
            "(formats.dia.select_diagonals) — the n-major kernel needs a "
            "constant-coefficient diagonal operator")
    with trace.span("plan.partition"):
        dia_host, rest = partition_dia(csr, offsets)
        masked = _maskable(dia_host)[1]
    if dtype == torch.float64:
        raise ValueError("strategy='nmajor' is fp32-only")
    if csr.num_rows != csr.num_cols or not masked:
        raise ValueError(
            "strategy='nmajor' requires a square constant-coefficient "
            "(maskable) diagonal operator")
    with trace.span("plan.operand"):
        dev = to_device_dia_nmajor(dia_host, L, device)
        rest_plan = to_device_merge(rest, device) if rest.nnz > 0 else None
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
    with trace.span("plan.select"):
        offsets = select_diagonals(csr)
    if offsets.size == 0:
        raise ValueError(
            "plan_dia_bf16: no dense diagonals selected — the bf16-plane "
            "plan needs a diagonal-structured operator")
    with trace.span("plan.partition"):
        dia_host, rest = partition_dia(csr, offsets)
        masked = _maskable(dia_host)[1]
    if masked:
        warnings.warn(
            "plan_dia_bf16: the operator is constant-coefficient — the "
            "exact masked plan (strategy='dia') reads 4 B/row and beats "
            "bf16 value planes; proceeding as requested", stacklevel=2)
    with trace.span("plan.operand"):
        dev = to_device_dia(dia_host, device, plane_dtype=torch.bfloat16)
        rest_plan = to_device_merge(rest, device) if rest.nnz > 0 else None
    return HybridPlan(dev, rest_plan, csr.nnz)


def kernel_layout(T: torch.Tensor) -> torch.Tensor:
    """``T`` made contiguous, the layout a DIA kernel reads, at the
    public ``spmm`` boundary. A copy opens a ``dia.layout`` span; the
    ``spmm.layout_bytes`` counter gets the bytes it reads and writes,
    or 0 where ``T`` is contiguous already (a 1-D X's X.T, an (L, n)
    block's transposed view, or a row-major (n, L) block for K7)."""
    if T.is_contiguous():
        trace.count("spmm.layout_bytes", 0)
        return T
    with trace.span("dia.layout"):
        T = T.contiguous()
    trace.count("spmm.layout_bytes", 2 * T.numel() * T.element_size())
    return T


def _masked_matvec(D: DiaStreamDevice, x):
    return spmm_dia_stream_t(D, x.to(D.vals.dtype).reshape(1, -1))[0]


def _masked_matmat(D: DiaStreamDevice, X):
    """A @ X, X cast to the band's type. The kernel follows X's layout: a
    row-major float32 block of 2 to 128 columns runs K7 on X as it is,
    over the same band, and Y comes back row-major (counter
    ``spmm.nmajor``); any other X runs K1 or K1d on X.T, which is
    contiguous already for L = 1 or an (L, n) block's transposed view,
    and Y comes back as a transposed view of the (L, n) result. K7
    equals K1 on X.T bit for bit, so Y's values do not depend on the
    route."""
    X = X.to(D.vals.dtype)
    if (X.dtype == torch.float32 and X.is_contiguous()
            and 2 <= X.shape[1] <= LANE_COUNTS[-1]):
        trace.count("spmm.nmajor")
        return nmajor_matmat(D, kernel_layout(X))
    return spmm_dia_stream_t(D, kernel_layout(X.T)).T


def _planes_matvec(D: DiaDevice, x):
    XT = x.reshape(1, -1).to(planes_value_dtype(D)).contiguous()
    return spmm_dia_planes_t(D, XT)[0]


def _planes_matmat(D: DiaDevice, X):
    """K5 or K5d on X.T, in the planes' compute type."""
    return spmm_dia_planes_t(
        D, kernel_layout(X.to(planes_value_dtype(D)).T)).T


def _nmajor_matvec(N: DiaNMajorDevice, x):
    return nmajor_matmat(
        N.band, x.to(torch.float32).reshape(-1, 1).contiguous())[:, 0]


def _nmajor_matmat(N: DiaNMajorDevice, X):
    """K7 on X cast to float32, at most the plan's ``L`` columns."""
    if X.shape[1] > N.L:
        raise ValueError(
            f"n-major plan built for L <= {N.L} RHS columns, got "
            f"{X.shape[1]}; rebuild with plan_matrix(..., "
            f"strategy='nmajor', L={X.shape[1]})")
    return nmajor_matmat(N.band, kernel_layout(X.to(torch.float32)))


def _one_column(matmat):
    """The vector product of a block product: x as one column."""
    return lambda A, x: matmat(A, x.reshape(-1, 1))[:, 0]


def _row_split_matmat(A: RowSplitDevice, X):
    return row_split_matmat(A, X.to(A.values.dtype).contiguous())


def _bsr_matmat(A: BcsrMatrix, X):
    return bsr_matmat(A, X.to(A.blocks.dtype).contiguous())


def _hybrid(which: str):
    """The product ``which`` of a HybridPlan: its DIA part's, plus its
    remainder's where it has one."""
    def product(H: HybridPlan, X):
        Y = getattr(_operand(H.dia), which)(H.dia, X)
        if H.rest is None:
            return Y
        return Y + getattr(_operand(H.rest), which)(H.rest, X)
    return product


def _reordered(which: str):
    """The product ``which`` of a ReorderedPlan: X permuted by K6, the
    inner plan's product, permuted back by K6."""
    def product(R: ReorderedPlan, X):
        Xp = R.apply_perm(X.to(_vector_dtype(R)))
        return R.apply_inv(getattr(_operand(R.inner), which)(R.inner, Xp))
    return product


class _Operand(NamedTuple):
    """What the dispatch layer knows of one operand type."""

    kind: Callable     # A -> plan_kind's label (the JAX package's)
    dtype: Callable    # A -> the stored value type
    matvec: Callable   # (A, x (num_cols,)) -> A @ x, unscaled
    matmat: Callable   # (A, X (num_cols, L)) -> A @ X, unscaled


def _values(A) -> torch.dtype:
    return A.values.dtype


_OPERANDS = {
    DiaStreamDevice: _Operand(
        lambda D: "dia", lambda D: D.vals.dtype, _masked_matvec,
        _masked_matmat),
    DiaDevice: _Operand(
        lambda D: "dia_bf16" if D.data.dtype == torch.bfloat16 else "dia",
        lambda D: D.data.dtype, _planes_matvec, _planes_matmat),
    DiaNMajorDevice: _Operand(
        lambda N: "dia_nmajor", lambda N: N.band.vals.dtype, _nmajor_matvec,
        _nmajor_matmat),
    MergeDevice: _Operand(
        lambda A: "merge", _values,
        lambda A, x: merge_matvec(A, x.to(A.values.dtype)),
        lambda A, X: merge_matmat(A, X.to(A.values.dtype).contiguous())),
    RowSplitDevice: _Operand(
        lambda A: "row_split", _values, _one_column(_row_split_matmat),
        _row_split_matmat),
    BcsrMatrix: _Operand(
        lambda A: "bsr", lambda A: A.blocks.dtype, _one_column(_bsr_matmat),
        _bsr_matmat),
    CsrMatrix: _Operand(
        lambda A: "reference", _values,
        lambda A, x: csr_matvec(A.num_rows, A.row_offsets, A.col_indices,
                                A.values, x),
        lambda A, X: csr_matmat(A.num_rows, A.row_offsets, A.col_indices,
                                A.values, X)),
    HybridPlan: _Operand(
        lambda H: (plan_kind(H.dia) if H.rest is None
                   else "hybrid_" + plan_kind(H.dia)),
        lambda H: plan_dtype(H.dia), _hybrid("matvec"), _hybrid("matmat")),
    ReorderedPlan: _Operand(
        lambda R: f"{R.order}+{plan_kind(R.inner)}",
        lambda R: plan_dtype(R.inner), _reordered("matvec"),
        _reordered("matmat")),
}


def _operand(A) -> _Operand:
    op = _OPERANDS.get(type(A))
    if op is None:
        raise TypeError(f"not a plan: {type(A).__name__}")
    return op


def plan_dtype(A) -> torch.dtype:
    """The stored value type of a plan: float32 or float64, or bf16 for
    bf16 value planes (a hybrid takes it from its DIA part, whose
    remainder then holds float32)."""
    return _operand(A).dtype(A)


def plan_kind(A) -> str:
    """Short name of a plan's kernel family (the JAX package's labels);
    a reordered plan is ``order + "+" + `` its inner plan's."""
    return _operand(A).kind(A)


def plan_semantics(A) -> str:
    """Numeric semantics a plan's kernels deliver, with the JAX
    package's labels: ``'ieee-f64'`` for a float64 plan (strict IEEE
    float64, every kernel K1d-K5d and the reference product),
    ``'bf16-plane(~4e-3)'`` for bf16 value planes (a hybrid takes it
    from its DIA part, as in the JAX package), else ``'f32'``. The
    JAX package's ``'double-float(~1e-14)'`` plans have no counterpart."""
    return {torch.float64: "ieee-f64",
            torch.bfloat16: "bf16-plane(~4e-3)"}.get(plan_dtype(A), "f32")


def _vector_dtype(A) -> torch.dtype:
    """The type of the vectors a plan computes on: float64 for a float64
    plan, else float32 (bf16 planes are upcast in the kernel)."""
    return torch.float64 if plan_dtype(A) == torch.float64 else torch.float32


def device_operand(A, like: torch.Tensor):
    """``A``, or for a host ``CsrMatrix`` (numpy arrays) the same matrix
    on ``like``'s device in ``like``'s type: the JAX package runs its
    reference product on a host CSR."""
    if isinstance(A, CsrMatrix) and not isinstance(A.values, torch.Tensor):
        return A.to(like.device, like.dtype)
    return A


def _scaled(Y_new, alpha, beta, Y):
    """alpha * Y_new + beta * Y, the epilogue of every product: Y_new as
    it is at alpha = 1 when beta = 0 or there is no Y."""
    if beta == 0.0 or Y is None:
        return alpha * Y_new if alpha != 1.0 else Y_new
    return alpha * Y_new + beta * Y


def spmv(A, x, alpha=1.0, beta=0.0, y=None, strategy="auto"):
    """y = alpha * A @ x + beta * y for any plan of ``plan_matrix``, or
    a host ``CsrMatrix`` (``device_operand``). ``strategy`` is the JAX
    package's argument: validated only, since on a plan the product
    does not depend on it."""
    with trace.span("spmv"):
        SpmvStrategy.parse(strategy)
        A = device_operand(A, x)
        return _scaled(_operand(A).matvec(A, x), alpha, beta, y)


def spmm(A, X, alpha=1.0, beta=0.0, Y=None, strategy="auto"):
    """Y = alpha * A @ X + beta * Y for any plan of ``plan_matrix`` (or
    a host ``CsrMatrix``), X of shape (num_cols, L); a 1-D X (and Y) is
    taken as L = 1 and the result is 1-D. ``strategy`` as in ``spmv``."""
    with trace.span("spmm"):
        SpmvStrategy.parse(strategy)
        A = device_operand(A, X)
        matmat = _operand(A).matmat
        if X.dim() == 1:
            Y_new = matmat(A, X.reshape(-1, 1))[:, 0]
        else:
            Y_new = matmat(A, X)
        return _scaled(Y_new, alpha, beta, Y)


def dia_t_product(A):
    """The kernel call on (L, num_cols) -> (L, num_rows) blocks of a plan
    that is all diagonal runs (a bare DIA operand, or a HybridPlan with
    no remainder): K1 or K1d on a masked band, K5 or K5d on value
    planes; None for any other plan, an n-major one included."""
    D = A.dia if isinstance(A, HybridPlan) and A.rest is None else A
    if isinstance(D, DiaStreamDevice):
        return lambda P: spmm_dia_stream_t(D, P)
    if isinstance(D, DiaDevice):
        return lambda P: spmm_dia_planes_t(D, P)
    return None


def block_product(A, B: torch.Tensor):
    """``(matmat, lane_dim)``: the block product a blocked solver runs on
    plan ``A`` for B (n, L), and the dimension of its state that holds
    the lanes. A plan that is all diagonal runs, masked or value planes,
    runs K1, K1d, K5 or K5d on (L, n) state (0), the kernels' own
    layout, with no transposes (``dia_t_product``); a pure n-major plan
    with a float32 B of at most its ``L`` columns runs K7 on (n, L) state
    (1); every other plan runs ``spmm`` on (n, L) state (1)."""
    mm_t = dia_t_product(A)
    if mm_t is not None:
        return mm_t, 0
    D = A.dia if isinstance(A, HybridPlan) and A.rest is None else A
    if (isinstance(D, DiaNMajorDevice) and B.dtype == torch.float32
            and B.shape[1] <= D.L):
        return (lambda P: nmajor_matmat(D.band, P)), 1
    return (lambda P: spmm(A, P)), 1
