"""Triangular solves for the IC(0) preconditioner (port of
``tpusparse/precond/trisolve.py``).

The reference applies z = (L L^T)^{-1} r by two row-sequential
substitutions per iteration. Three forms here:

  * ``forward_solve_host`` / ``backward_solve_host``: the exact numpy
    substitutions (the oracle);
  * ``JacobiTriSolver`` (``jacobi_trisolve_lower/upper``): a fixed
    number of Jacobi sweeps z <- D^{-1} (b - (T - D) z), each an
    ``spmv``/``spmm`` of the strict triangle on a port plan (K1, K2, K3
    or K5 and their float64 twins, as AUTO plans it); T - D is
    nilpotent, so as many sweeps as the factor has dependency levels give
    the exact solve;
  * ``LevelScheduledSolver``: the exact solve by dependency levels: the
    rows of a level depend only on earlier levels and solve together.
    The host schedule is the JAX package's, padded to (nlev, R) rows and
    (n + 1, K) strict slots, and is gathered per level once at build.
    The loop over levels is an eager Python loop of five tensor ops per
    level (gather, batched product, subtract, scale, scatter): its cost
    is the number of levels times the launch cost, which CUDA graphs
    would remove (ROADMAP A7b).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.ops.spmv import plan_matrix, spmm, spmv
from tpusparse_torch.precond.ic0 import IMPLS, default_impl


def forward_solve_host(L, b):
    """Solve L x = b for a lower-triangular host CSR with sorted columns
    (diagonal last in each row); b (n,) or (n, L_rhs)."""
    ro = np.asarray(L.row_offsets)
    ci = np.asarray(L.col_indices)
    va = np.asarray(L.values)
    b = np.asarray(b)
    x = np.zeros_like(b, dtype=np.float64)
    for i in range(L.num_rows):
        s0, s1 = ro[i], ro[i + 1]
        x[i] = (b[i] - va[s0:s1 - 1] @ x[ci[s0:s1 - 1]]) / va[s1 - 1]
    return x


def backward_solve_host(L, b):
    """Solve L^T x = b given the lower-triangular L (through its
    transpose, whose rows hold the diagonal first)."""
    U = L.transpose()
    ro = np.asarray(U.row_offsets)
    ci = np.asarray(U.col_indices)
    va = np.asarray(U.values)
    b = np.asarray(b)
    x = np.zeros_like(b, dtype=np.float64)
    for i in range(U.num_rows - 1, -1, -1):
        s0, s1 = ro[i], ro[i + 1]
        x[i] = (b[i] - va[s0 + 1:s1] @ x[ci[s0 + 1:s1]]) / va[s0]
    return x


def split_diag(T: CsrMatrix):
    """A triangular host CSR as (strict part, diagonal)."""
    ci = np.asarray(T.col_indices)
    va = np.asarray(T.values)
    rows = T.row_ids()
    is_diag = ci == rows
    diag = np.zeros(T.num_rows, dtype=va.dtype)
    diag[rows[is_diag]] = va[is_diag]
    keep = ~is_diag
    ro = np.zeros(T.num_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows[keep], minlength=T.num_rows), out=ro[1:])
    return CsrMatrix(T.num_rows, T.num_cols, ro, ci[keep].astype(np.int32),
                     va[keep].copy()), diag


class JacobiTriSolver:
    """Fixed-sweep Jacobi solve of T x = b on the device: ``strict`` is a
    plan of T - diag(T), ``inv_diag`` the reciprocal diagonal. At least as
    many sweeps as T has dependency levels give the exact solve."""

    def __init__(self, strict, inv_diag: torch.Tensor, sweeps: int = 12):
        self.strict = strict
        self.inv_diag = inv_diag
        self.sweeps = sweeps

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if b.dim() == 1:
            d = self.inv_diag
            x = b * d
            for _ in range(self.sweeps):
                x = (b - spmv(self.strict, x)) * d
            return x
        d = self.inv_diag[:, None]
        x = b * d
        for _ in range(self.sweeps):
            x = (b - spmm(self.strict, x)) * d
        return x


def _jacobi(T, sweeps, to_plan, num_rhs, dtype, device) -> JacobiTriSolver:
    strict, diag = split_diag(T)
    if dtype is not None:
        strict, diag = strict.astype(dtype), diag.astype(dtype)
    plan = (to_plan(strict) if to_plan else
            plan_matrix(strict, "auto", dtype=strict.values.dtype,
                        L=num_rhs, device=device))
    return JacobiTriSolver(plan, torch.from_numpy(1.0 / diag).to(device),
                           sweeps)


def jacobi_trisolve_lower(L_host, sweeps: int = 12, to_plan=None,
                          num_rhs: int = 16, dtype=None, device="cuda"):
    """A ``JacobiTriSolver`` for L x = b from a host lower CSR. ``dtype``
    casts the factor before planning: ``ic0_factorize`` returns a float64
    factor, and uncast a float32 solve would plan float64 sweeps.
    ``to_plan`` replaces the AUTO planner (sized for ``num_rhs``)."""
    return _jacobi(L_host, sweeps, to_plan, num_rhs, dtype, device)


def jacobi_trisolve_upper(L_host, sweeps: int = 12, to_plan=None,
                          num_rhs: int = 16, dtype=None, device="cuda"):
    """A ``JacobiTriSolver`` for L^T x = b (see
    ``jacobi_trisolve_lower``)."""
    return _jacobi(L_host.transpose(), sweeps, to_plan, num_rhs, dtype,
                   device)


def _dependency_levels(ro, ci, n, lower, impl=None) -> np.ndarray:
    """Level of each row of a triangular CSR: 1 + the largest level of
    its strict dependencies. ``impl="native"`` is the C++ walk of
    ``csrc/ic0_host.cpp``, ``"python"`` numpy frontier propagation
    (default: ``ic0.default_impl()``)."""
    impl = default_impl() if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    if impl == "native":
        from tpusparse_torch.kernels import _build

        ro64 = np.ascontiguousarray(ro, dtype=np.int64)
        ci32 = np.ascontiguousarray(ci, dtype=np.int32)
        out = np.zeros(max(int(n), 1), dtype=np.int32)
        _build.library().tps_tri_levels(int(n), ro64.ctypes.data,
                                        ci32.ctypes.data, 1 if lower else 0,
                                        out.ctypes.data)
        return out[:n].astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    strict = ci != rows
    srow, scol = rows[strict], ci[strict]
    level = np.full(n, -1, dtype=np.int64)
    level[np.bincount(srow, minlength=n) == 0] = 0
    big = np.iinfo(np.int64).max
    while True:
        pending = level[srow] < 0
        if not pending.any():
            return level
        dep_lev = level[scol]
        ready_min = np.full(n, big, dtype=np.int64)
        np.minimum.at(ready_min, srow[pending], dep_lev[pending])
        ready_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(ready_max, srow[pending], dep_lev[pending])
        ready = (level < 0) & (ready_min >= 0) & (ready_min < big)
        if not ready.any():
            raise ValueError("cycle in triangular structure")
        level[ready] = ready_max[ready] + 1


class LevelScheduledSolver:
    """Exact triangular solve of T x = b by dependency levels, on
    ``device``. ``nlev`` sequential steps, each over the rows of one level
    (padded to R rows, the sentinel row n reading and writing zeros).
    The solve runs in the promoted type of b and the factor (float64 for
    an IC(0) factor) and returns b's type."""

    def __init__(self, T: CsrMatrix, lower: bool = True, device="cuda",
                 impl=None):
        ro = np.asarray(T.row_offsets).astype(np.int64)
        ci = np.asarray(T.col_indices).astype(np.int64)
        va = np.asarray(T.values)
        n = T.num_rows
        rows = T.row_ids().astype(np.int64)
        is_diag = ci == rows
        diag = np.zeros(n, dtype=np.float64)
        diag[rows[is_diag]] = va[is_diag]

        level = _dependency_levels(ro, ci, n, lower, impl)
        nlev = int(level.max()) + 1 if n else 1
        R = max(int(np.bincount(level, minlength=nlev).max()), 1)
        K = max(int(np.bincount(rows[~is_diag], minlength=n).max())
                if n else 0, 1)

        order = np.argsort(level, kind="stable")
        lvl_sorted = level[order]
        starts = np.searchsorted(lvl_sorted, np.arange(nlev))
        rank = np.arange(n, dtype=np.int64) - starts[lvl_sorted]
        rows_of_level = np.full((nlev, R), n, dtype=np.int64)
        rows_of_level[lvl_sorted, rank] = order

        # strict slot of each entry within its row: its place in the row
        # less one where the row's diagonal comes before it
        within = np.arange(ci.size, dtype=np.int64) - ro[rows]
        diag_within = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        diag_within[rows[is_diag]] = within[is_diag]
        k_slot = within - (diag_within[rows] < within)
        cols_pad = np.full((n + 1, K), n, dtype=np.int64)
        vals_pad = np.zeros((n + 1, K), dtype=va.dtype)
        strict = ~is_diag
        cols_pad[rows[strict], k_slot[strict]] = ci[strict]
        vals_pad[rows[strict], k_slot[strict]] = va[strict]
        inv_diag = np.concatenate([1.0 / diag, [0.0]]).astype(va.dtype)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.n, self.nlev, self.R, self.K = n, nlev, R, K
        self.rows_of_level = dev(rows_of_level)              # (nlev, R)
        self.cols = dev(cols_pad[rows_of_level])             # (nlev, R, K)
        self.vals = dev(vals_pad[rows_of_level][:, :, None, :])  # (.,R,1,K)
        self.inv_diag = dev(inv_diag[rows_of_level][:, :, None])  # (.,R,1)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        B = b[:, None] if b.dim() == 1 else b
        L = B.shape[1]
        wt = torch.promote_types(B.dtype, self.vals.dtype)
        vals, inv_diag = self.vals.to(wt), self.inv_diag.to(wt)
        x = torch.zeros((self.n + 1, L), dtype=wt, device=B.device)
        Bp = torch.cat([B.to(wt), x[:1]])
        Bl = Bp.index_select(0, self.rows_of_level.reshape(-1)).reshape(
            self.nlev, self.R, L)
        for lv in range(self.nlev):
            g = x.index_select(0, self.cols[lv].reshape(-1)).reshape(
                self.R, self.K, L)
            s = torch.matmul(vals[lv], g)[:, 0]                # (R, L)
            x.index_copy_(0, self.rows_of_level[lv],
                          (Bl[lv] - s) * inv_diag[lv])
        x = x[:self.n].to(b.dtype)
        return x[:, 0] if b.dim() == 1 else x


def level_trisolve_lower(L_host, device="cuda", impl=None):
    """Exact lower solve L x = b by level scheduling."""
    return LevelScheduledSolver(L_host, lower=True, device=device, impl=impl)


def level_trisolve_upper(L_host, device="cuda", impl=None):
    """Exact upper solve L^T x = b by level scheduling."""
    return LevelScheduledSolver(L_host.transpose(), lower=False,
                                device=device, impl=impl)
