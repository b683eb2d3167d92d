"""Golden-model SpMV — the correctness anchors.

Port of ``tpusparse/ops/reference.py``:

  * ``spmv_numpy`` — host golden model, always in float64;
  * ``csr_matvec`` / ``csr_matmat`` — the golden CSR products, in the
    dtype of the values (float64 values give the float64 golden
    product), which ``spmv`` / ``spmm`` run on a ``CsrMatrix`` operand
    (the ``reference`` strategy). On the
    CPU: gather x (or the rows of X), multiply, ``index_add_`` over
    expanded row ids, which adds each row's products in CSR order. On
    the card: the kernel KR (KRd in float64,
    ``kernels/csr_reference.py``), which adds in the same order and so
    gives the CPU's bits on every call, where CUDA's ``index_add_`` adds
    with atomics in no fixed order;
  * ``csr_matvec_plain`` / ``csr_matmat_plain`` — the ``index_add_``
    products on any device (``kernels/csr_reference.py``): the plain
    versions behind the merge and row-split kernels and KR.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels.csr_reference import (  # noqa: F401
    csr_matmat_plain,
    csr_matvec_plain,
    csr_reference_kernel,
    expand_row_ids,
)


def csr_matvec(num_rows: int, row_offsets, col_indices, values,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR tensors in the dtype of ``values``: KR (KRd) on
    a CUDA tensor, ``csr_matvec_plain`` on the CPU; the same bits."""
    if values.device.type == "cuda":
        return csr_reference_kernel(num_rows, row_offsets, col_indices,
                                    values, x.reshape(-1, 1)).reshape(-1)
    return csr_matvec_plain(num_rows, row_offsets, col_indices, values, x)


def csr_matmat(num_rows: int, row_offsets, col_indices, values,
               X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for CSR tensors and X (num_cols, L) in the dtype of
    ``values``: KR (KRd) on a CUDA tensor, ``csr_matmat_plain`` on the
    CPU; the same bits."""
    if values.device.type == "cuda":
        return csr_reference_kernel(num_rows, row_offsets, col_indices,
                                    values, X)
    return csr_matmat_plain(num_rows, row_offsets, col_indices, values, X)


def spmv_numpy(csr, x, alpha=1.0, beta=0.0, y=None) -> np.ndarray:
    """Pure-numpy golden model in float64 (host oracle)."""
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices)
    va = np.asarray(csr.values, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    rows = np.repeat(np.arange(csr.num_rows), np.diff(ro))
    y_new = np.zeros(csr.num_rows, dtype=np.float64)
    np.add.at(y_new, rows, va * x[ci])
    if beta == 0.0 or y is None:
        return alpha * y_new
    return alpha * y_new + beta * np.asarray(y, dtype=np.float64)
