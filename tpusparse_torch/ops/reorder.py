"""Symmetric relabeling and bandwidth-reducing (RCM) reordering.

Port of ``tpusparse/ops/reorder.py``. A reverse-Cuthill-McKee order
collapses a scrambled banded matrix back to a narrow band, which the
planner then runs on the DIA kernels or as a merge plan whose x gathers
stay local. ``P A P^T`` is similar to ``A``, so CG takes the same
iterations up to rounding.

``ReorderedPlan`` wraps any plan of the permuted matrix; ``spmv`` and
``spmm`` dispatch on it as ``y = (alpha A_p @ x[perm])[inv_perm] + beta
y``, and the solvers (CG, PCG, SPAI-CG) permute b once on the way in and
x once on the way out; a preconditioner for such a plan is built from
``ReorderedPlan.permuted(csr)``. Every permutation of a device vector or
block goes through K6 (``kernels/permute.py``), in float32 and float64,
at any L.

``plan_reorder(order='auto')`` keeps only the JAX package's primary
gate: RCM is applied when its bandwidth, plus ``RCM_SLACK``, is at most
``RCM_GAIN`` of the original's. The JAX package's secondary candidates
(RCM on a mean-bandwidth prefilter, degree order on concentrated column
degrees) are ranked by ``formats/tiles.choose_partition_params``, the
occupancy score of the TPU's host merge-tile partition, which the port
does not have (its merge-path search runs on the device). So where the
primary gate fails, the port's 'auto' returns the unpermuted plan; the
JAX package reorders sparse R-MAT graphs there (rmat-14-ef4 and
rmat-16-ef4 by degree). A locality gate of the port's own waits for
measurements on the card (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.kernels.permute import build_permute_plan, permute_apply
from tpusparse_torch.utils import trace

# reorder='auto': apply RCM only when its bandwidth undercuts a quarter
# of the original's by at least a 128-column band (the JAX package's
# primary gate).
RCM_GAIN = 0.25
RCM_SLACK = 128
# degree-concentration threshold of the JAX package's secondary degree
# candidate (``_degree_concentration``), kept with that function
DEGREE_TOP_FRAC = 0.25


def bandwidth(csr: CsrMatrix, perm=None) -> int:
    """max |i - j| over the stored entries (0 for an empty matrix); with
    ``perm``, that of ``permute_symmetric(csr, perm)``."""
    ci = np.asarray(csr.col_indices).astype(np.int64)
    if ci.size == 0:
        return 0
    rows = csr.row_ids().astype(np.int64)
    if perm is not None:
        inv = np.argsort(np.asarray(perm, dtype=np.int64))
        rows, ci = inv[rows], inv[ci]
    return int(np.abs(rows - ci).max())


def permute_symmetric(csr: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """``A_p[i, j] = A[perm[i], perm[j]]`` (row i of the result is row
    ``perm[i]`` of the input; the reference's ``InitCsrRelabel`` with
    ``relabel = argsort(perm)``). Square matrices only. The entries are
    sorted by (row, column) with ``np.lexsort``, which gives the order of
    the JAX package's native counting sort."""
    if csr.num_rows != csr.num_cols:
        raise ValueError("symmetric permutation needs a square matrix")
    n = csr.num_rows
    perm = np.asarray(perm, dtype=np.int64)
    if perm.shape != (n,):
        raise ValueError(f"perm must have shape ({n},)")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    new_rows = inv[csr.row_ids()]
    new_cols = inv[np.asarray(csr.col_indices)]
    o = np.lexsort((new_cols, new_rows))
    ro = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=n), out=ro[1:])
    return CsrMatrix(
        n, n, ro.astype(np.asarray(csr.row_offsets).dtype),
        new_cols[o].astype(np.asarray(csr.col_indices).dtype),
        np.asarray(csr.values)[o])


def degree_order(csr: CsrMatrix) -> np.ndarray:
    """Columns by descending degree (hub columns first), stable, in the
    gather convention of ``permute_symmetric``."""
    ci = np.asarray(csr.col_indices).astype(np.int64)
    deg = np.bincount(ci, minlength=csr.num_cols)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def _degree_concentration(csr: CsrMatrix) -> float:
    """Fraction of the nonzeros in the top ~3 % highest-degree columns
    (at least 128); 0.0 under 1024 columns. The JAX package's prefilter
    for its degree candidate (at least ``DEGREE_TOP_FRAC`` there)."""
    ci = np.asarray(csr.col_indices).astype(np.int64)
    if ci.size == 0 or csr.num_cols < 1024:
        return 0.0
    deg = np.bincount(ci, minlength=csr.num_cols)
    k = max(csr.num_cols // 32, 128)
    return float(np.sort(deg)[::-1][:k].sum()) / csr.nnz


def _dia_eligible(csr: CsrMatrix) -> bool:
    """Would AUTO peel this matrix onto a DIA kernel? (The coverage test
    of ``ops.spmv._try_plan_dia``.)"""
    from tpusparse_torch.formats.dia import diagonal_profile, select_diagonals
    from tpusparse_torch.ops.spmv import DIA_MIN_COVERAGE

    offsets = select_diagonals(csr)
    if offsets.size == 0:
        return False
    all_off, counts, _ = diagonal_profile(csr)
    covered = int(counts[np.isin(all_off, offsets)].sum())
    return covered >= DIA_MIN_COVERAGE * csr.nnz


def rcm_order(csr: CsrMatrix) -> np.ndarray:
    """Reverse-Cuthill-McKee order of the pattern (scipy's, called as
    the JAX package calls it), in the gather convention."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(csr.to_scipy().tocsr(),
                                            symmetric_mode=False),
                      dtype=np.int64)


@dataclasses.dataclass
class ReorderedPlan:
    """A plan of ``P A P^T`` and the permutation as int32 device tensors:
    ``perm`` (new -> old) and ``inv_perm`` (old -> new). ``order`` names
    the ordering ('rcm' or 'degree'), the ``plan_kind`` prefix."""

    num_rows: int
    num_cols: int
    nnz: int
    inner: Any
    perm: torch.Tensor
    inv_perm: torch.Tensor
    order: str = "rcm"

    def apply_perm(self, x: torch.Tensor) -> torch.Tensor:
        """``x[perm]`` (original -> permuted space), (n,) or (n, L): K6."""
        return permute_apply(self.perm, x)

    def apply_inv(self, y: torch.Tensor) -> torch.Tensor:
        """``y[inv_perm]`` (permuted -> original space): K6."""
        return permute_apply(self.inv_perm, y)

    def permuted(self, csr: CsrMatrix) -> CsrMatrix:
        """The host matrix ``csr`` in the plan's order, ``P A P^T``: build
        a preconditioner for this plan (IC(0), SPAI) from it."""
        return permute_symmetric(csr, self.perm.cpu().numpy())


def _wrap_reordered(csr, perm, strategy, dtype, L, order, device):
    from tpusparse_torch.ops.spmv import plan_matrix

    with trace.span("plan.reorder"):
        permuted = permute_symmetric(csr, perm)
    inner = plan_matrix(permuted, strategy=strategy, dtype=dtype, L=L,
                        device=device)
    with trace.span("plan.reorder"):
        fwd = build_permute_plan(perm, device)
        inv = build_permute_plan(np.argsort(perm), device)
    return ReorderedPlan(csr.num_rows, csr.num_cols, csr.nnz, inner, fwd,
                         inv, order)


def plan_reorder(csr: CsrMatrix, strategy="auto", dtype=None,
                 L: int = 1, order: str = "rcm", device="cuda"):
    """A plan of the symmetrically permuted matrix, wrapped so callers
    use it as any other plan. ``order='rcm'`` and ``'degree'`` always
    permute; ``'auto'`` applies RCM when the primary gate holds and
    otherwise returns the unpermuted plan (see the module docstring for
    the JAX package's secondary candidates, not ported). A matrix that
    is not square or has no entries is planned unpermuted. ``dtype`` as
    in ``plan_matrix``: None plans in the host values' type."""
    from tpusparse_torch.ops.spmv import plan_matrix

    if order not in ("rcm", "degree", "auto"):
        raise ValueError(f"unknown order {order!r}")
    if csr.num_rows != csr.num_cols or csr.nnz == 0:
        return plan_matrix(csr, strategy=strategy, dtype=dtype, L=L,
                           device=device)
    with trace.span("plan.reorder"):
        perm = degree_order(csr) if order == "degree" else rcm_order(csr)
        unpermuted = (order == "auto" and bandwidth(csr, perm) + RCM_SLACK
                      > RCM_GAIN * bandwidth(csr))
    if unpermuted:
        return plan_matrix(csr, strategy=strategy, dtype=dtype, L=L,
                           device=device)
    return _wrap_reordered(csr, perm, strategy, dtype, L,
                           "rcm" if order == "auto" else order, device)
