"""Golden-model SpMV — the correctness anchors.

Port of ``tpusparse/ops/reference.py``:

  * ``spmv_numpy`` — host golden model, always in float64;
  * ``spmv_reference`` / ``spmm_reference`` — the ``reference``
    strategy: ``csr_matvec`` / ``csr_matmat`` on the operand, in the
    dtype of its values (float64 values give the float64 golden
    product);
  * ``csr_matvec`` / ``csr_matmat`` — the golden CSR products. On the
    CPU: gather x (or the rows of X), multiply, ``index_add_`` over
    expanded row ids, which adds each row's products in CSR order. On
    the card: the kernel KR (KRd in float64,
    ``kernels/csr_reference.py``), which adds in the same order and so
    gives the CPU's bits on every call, where CUDA's ``index_add_`` adds
    with atomics in no fixed order;
  * ``csr_matvec_plain`` / ``csr_matmat_plain`` — the ``index_add_``
    products on any device: the plain versions behind the merge and
    row-split kernels and KR.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels.csr_reference import csr_reference_kernel


def expand_row_ids(row_offsets: torch.Tensor, num_rows: int,
                   nnz: int) -> torch.Tensor:
    """Per-nonzero row ids (nnz,) int64 from CSR row offsets (``nnz``
    given, so a CUDA expansion needs no host sync)."""
    lengths = (row_offsets[1:] - row_offsets[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(num_rows, device=row_offsets.device), lengths,
        output_size=nnz)


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


def csr_matvec_plain(num_rows: int, row_offsets, col_indices, values,
                     x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR tensors, in plain torch, in the dtype of
    ``values``."""
    rows = expand_row_ids(row_offsets, num_rows, col_indices.shape[0])
    prod = values * x.to(values.dtype)[col_indices.to(torch.int64)]
    y = torch.zeros(num_rows, dtype=values.dtype, device=values.device)
    return y.index_add_(0, rows, prod)


def csr_matmat_plain(num_rows: int, row_offsets, col_indices, values,
                     X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for CSR tensors and X (num_cols, L), in plain torch, in
    the dtype of ``values``: gather the rows of X, scale, ``index_add_``
    per row."""
    rows = expand_row_ids(row_offsets, num_rows, col_indices.shape[0])
    prod = values[:, None] * X.to(values.dtype)[col_indices.to(torch.int64)]
    Y = torch.zeros((num_rows, X.shape[1]), dtype=values.dtype,
                    device=values.device)
    return Y.index_add_(0, rows, prod)


def spmv_reference(csr, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y for a CsrMatrix of torch tensors."""
    y_new = csr_matvec(csr.num_rows, csr.row_offsets, csr.col_indices,
                       csr.values, x)
    if beta == 0.0 or y is None:
        return alpha * y_new
    return alpha * y_new + beta * y


def spmm_reference(csr, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y, X (num_cols, L), for a CsrMatrix of
    torch tensors."""
    Y_new = csr_matmat(csr.num_rows, csr.row_offsets, csr.col_indices,
                       csr.values, X)
    if beta == 0.0 or Y is None:
        return alpha * Y_new
    return alpha * Y_new + beta * Y


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
