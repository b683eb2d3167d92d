"""KR — the reference CSR product on the card, and KRd, its float64
twin (``csrc/csr_reference.cu``).

The kernel behind ``ops/reference.csr_matvec`` and ``csr_matmat`` on a
CUDA tensor, and so behind ``strategy='reference'``. One thread per row
and lane adds the row's products in CSR order from +0.0, each product
and sum rounded apart: the order in which the CPU's ``index_add_`` adds
them, so the card's Y is the CPU's bits and repeats them call after
call. CUDA's ``index_add_`` adds with atomics in no fixed order. It
replaces no Pallas kernel: the JAX package's reference product is XLA's
segment sum (``tpusparse/ops/reference.py``).

``csr_matvec_plain`` and ``csr_matmat_plain`` are the ``index_add_``
products on any device: the order KR adds in, and the plain versions
behind the merge and row-split kernels.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import trace


def expand_row_ids(row_offsets: torch.Tensor, num_rows: int,
                   nnz: int) -> torch.Tensor:
    """Per-nonzero row ids (nnz,) int64 from CSR row offsets (``nnz``
    given, so a CUDA expansion needs no host sync)."""
    lengths = (row_offsets[1:] - row_offsets[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(num_rows, device=row_offsets.device), lengths,
        output_size=nnz)


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


def csr_reference_kernel(num_rows: int, row_offsets: torch.Tensor,
                         col_indices: torch.Tensor, values: torch.Tensor,
                         X: torch.Tensor) -> torch.Tensor:
    """Y (num_rows, L) = A @ X for CUDA CSR tensors and X (num_cols, L),
    in the values' type (float32: KR, float64: KRd); X is cast to it.
    No rows or no lanes launch nothing. Raises for another value type or
    device; never falls back."""
    if values.device.type != "cuda":
        raise ValueError(f"KR runs on a CUDA tensor, got {values.device}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"KR takes float32 or float64 values, got "
                        f"{values.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be (num_cols, L), got {tuple(X.shape)}")
    dev = values.device
    if X.device != dev or row_offsets.device != dev \
            or col_indices.device != dev:
        raise ValueError("KR needs the CSR tensors and X on one device")
    L = X.shape[1]
    if num_rows == 0 or L == 0:
        return torch.zeros((num_rows, L), dtype=values.dtype, device=dev)
    f64 = values.dtype == torch.float64
    with trace.span("kernel.KRd" if f64 else "kernel.KR"):
        index64 = not (row_offsets.dtype == torch.int32
                       and col_indices.dtype == torch.int32)
        itype = torch.int64 if index64 else torch.int32
        ro = row_offsets.to(itype).contiguous()
        ci = col_indices.to(itype).contiguous()
        v = values.contiguous()
        Xc = X.to(values.dtype).contiguous()
        Y = torch.empty((num_rows, L), dtype=values.dtype, device=dev)
        _build.launch("tps_csr_reference_f64" if f64 else "tps_csr_reference",
                      "KRd" if f64 else "KR", dev, ro.data_ptr(),
                      ci.data_ptr(), v.data_ptr(), Xc.data_ptr(),
                      Y.data_ptr(), num_rows, L, int(index64))
        return Y
