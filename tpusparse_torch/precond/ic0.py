"""IC(0) incomplete Cholesky factorization (port of
``tpusparse/precond/ic0.py``).

The reference's ``IncompleteCholesky``: the pattern is the lower
triangle of A (columns sorted, so each row's diagonal is its last
entry); an up-looking factorization with sorted-merge partial dots; a
pivot <= 0 restarts from the original values with a diagonal shift of
1e-3, growing 10x per retry, up to 20 attempts. The factor is float64
whatever the system's type.

The factorization is sequential over rows and runs on the host. Two
implementations compute it: ``impl="native"``, the C++ loop of
``csrc/ic0_host.cpp`` in the kernels' library (built with nvcc at first
use, so only on a machine with the CUDA toolkit), and ``impl="python"``,
the reference loop below. The default is ``"native"`` where a card is
present and ``"python"`` otherwise; a failed build raises, it never
falls back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix

IMPLS = ("native", "python")


def default_impl() -> str:
    """``"native"`` on a machine with a card (where the kernels' library
    is built), else ``"python"``."""
    return "native" if torch.cuda.is_available() else "python"


def _lower_triangle(csr: CsrMatrix) -> CsrMatrix:
    ci = np.asarray(csr.col_indices)
    rows = csr.row_ids()
    keep = ci <= rows
    ro = np.zeros(csr.num_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows[keep], minlength=csr.num_rows), out=ro[1:])
    return CsrMatrix(csr.num_rows, csr.num_cols, ro,
                     ci[keep].astype(np.int32),
                     np.asarray(csr.values)[keep].copy())


def _try_factorize(ro, ci, vals) -> bool:
    """One up-looking IC(0) attempt, in place on ``vals`` (Python lists,
    which index faster than numpy arrays). Returns False on a pivot
    breakdown (diagonal <= 0)."""
    n = len(ro) - 1
    for i in range(n):
        for k_off in range(ro[i], ro[i + 1]):
            k = ci[k_off]
            s = 0.0
            jl, jk, end_k = ro[i], ro[k], ro[k + 1]
            while jl < k_off and jk < end_k:
                cl, ck = ci[jl], ci[jk]
                if cl == ck:
                    s += vals[jl] * vals[jk]
                    jl += 1
                    jk += 1
                elif cl < ck:
                    jl += 1
                else:
                    jk += 1
            vals[k_off] -= s
            if k == i:
                if vals[k_off] <= 0:
                    return False
                vals[k_off] = math.sqrt(vals[k_off])
            else:
                vals[k_off] /= vals[ro[k + 1] - 1]
    return True


def _factorize_python(ro, ci, backup, diag_mask, max_attempts,
                      initial_shift):
    ro, ci = ro.tolist(), ci.tolist()
    shift = 0.0
    for attempt in range(max_attempts):
        vals = backup.copy()
        if attempt > 0:
            vals[diag_mask] += shift
        vals = vals.tolist()
        if _try_factorize(ro, ci, vals):
            return np.array(vals, dtype=np.float64)
        shift = initial_shift if shift == 0.0 else shift * 10.0
    return None


def _factorize_native(ro, ci, backup, max_attempts, initial_shift):
    from tpusparse_torch.kernels import _build

    vals = np.empty_like(backup)
    used = _build.library().tps_ic0_factorize(
        ro.size - 1, ro.ctypes.data, ci.ctypes.data, backup.ctypes.data,
        vals.ctypes.data, int(max_attempts), float(initial_shift))
    return vals if used else None


def ic0_factorize(csr: CsrMatrix, max_attempts: int = 20,
                  initial_shift: float = 1e-3, impl: str | None = None
                  ) -> CsrMatrix:
    """Factor A ~= L L^T on the lower-triangle pattern of the host matrix
    ``csr``; returns L as a host CsrMatrix with float64 values. Raises
    RuntimeError after ``max_attempts`` diagonal-shift attempts.
    ``impl`` is ``"native"`` or ``"python"`` (default:
    ``default_impl()``)."""
    impl = default_impl() if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    L = _lower_triangle(csr)
    ro = np.ascontiguousarray(L.row_offsets, dtype=np.int64)
    ci = np.ascontiguousarray(L.col_indices, dtype=np.int64)
    backup = np.ascontiguousarray(L.values, dtype=np.float64)
    if impl == "native":
        vals = _factorize_native(ro, ci, backup, max_attempts, initial_shift)
    else:
        vals = _factorize_python(ro, ci, backup, ci == L.row_ids(),
                                 max_attempts, initial_shift)
    if vals is None:
        raise RuntimeError(
            f"IC(0) failed after {max_attempts} diagonal-shift attempts")
    return CsrMatrix(L.num_rows, L.num_cols, L.row_offsets, L.col_indices,
                     vals)
