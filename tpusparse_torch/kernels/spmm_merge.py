"""Merge-path CSR SpMM — kernel K3 and its float64 twin K3d.

Port of ``tpusparse/kernels/spmm_merge.py``. The operand is K2's merge
plan (``merge_spmv.MergeDevice``, the CSR on the device): one plan
serves SpMV (K2) and SpMM (K3), as the JAX package's merge tiles serve
both of its kernels.

K3 (``csrc/merge_spmm.cu``) replaces the Pallas kernel
``tpusparse/kernels/spmm_merge.py::_spmm_tiles``: K2's search, consume
and fix-up with the RHS lanes inside each CTA, so the matrix payload
streams once for all L lanes, and no float atomics, so two runs give
bitwise equal Y. The TPU wrapper's lane padding to multiples of 8, its
VMEM lane chunks and its overflow COO stream have no counterpart. K3d,
the same template at IEEE float64, replaces the double-float (two-f32)
kernel ``tpusparse/kernels/merge_df.py::_spmm_tiles_df``. A kernel runs
in the operand's value type: ``scaled_product`` casts X to it, and a
kernel-level call with X of another type raises TypeError.
"""

from __future__ import annotations

import torch

from tpusparse_torch.formats.csr import VALUE_DTYPES
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.merge_spmv import MergeDevice
from tpusparse_torch.ops.reference import csr_matmat

# K3 launches since the count was last reset (plain runs not counted).
LAUNCHES = 0
# K3d (float64) launches, counted apart from K3's.
LAUNCHES_F64 = 0


def spmm_merge_plain(A: MergeDevice, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 and K3d: gather the rows of X,
    multiply, ``index_add_`` per row, in the values' dtype."""
    return csr_matmat(A.num_rows, A.row_offsets, A.col_indices, A.values, X)


def check_operands(A, X: torch.Tensor, kernel: str) -> None:
    """Raise unless X (num_cols, L) and the CSR operand ``A`` are what a
    CSR SpMM kernel takes: X in the operand's value type (float32 or
    float64), int32 indices, contiguous, one device."""
    if X.dim() != 2 or X.shape[0] != A.num_cols or X.shape[1] < 1:
        raise ValueError(
            f"X must be ({A.num_cols}, L >= 1), got {tuple(X.shape)}")
    if A.values.dtype not in VALUE_DTYPES or X.dtype != A.values.dtype:
        raise TypeError(f"{kernel} takes X in its operand's type "
                        f"({A.values.dtype}), got {X.dtype}")
    if (A.row_offsets.dtype != torch.int32
            or A.col_indices.dtype != torch.int32):
        raise TypeError(f"{kernel} needs int32 row offsets and column "
                        "indices")
    if (A.row_offsets.shape != (A.num_rows + 1,)
            or A.values.shape != A.col_indices.shape):
        raise ValueError("inconsistent CSR array shapes")
    if not all(t.is_contiguous() for t in
               (X, A.row_offsets, A.col_indices, A.values)):
        raise ValueError(f"{kernel} needs contiguous operands")
    if any(t.device != X.device for t in
           (A.row_offsets, A.col_indices, A.values)):
        raise ValueError(f"X on {X.device}, operand elsewhere: same device "
                         "needed")


def _launch(A: MergeDevice, X: torch.Tensor) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F64
    lib = _build.library()
    L = X.shape[1]
    num_tiles = -(-(A.num_rows + A.nnz) // lib.tps_merge_tile_items())
    dev = X.device
    Y = torch.empty((A.num_rows, L), dtype=X.dtype, device=dev)
    if num_tiles == 0:
        return Y
    coords = torch.empty((num_tiles + 1, 2), dtype=torch.int32, device=dev)
    carry_rows = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    carry_vals = torch.empty((num_tiles, L), dtype=X.dtype, device=dev)
    f64 = X.dtype == torch.float64
    name = "tps_merge_spmm_f64" if f64 else "tps_merge_spmm"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            A.row_offsets.data_ptr(), A.col_indices.data_ptr(),
            A.values.data_ptr(), X.data_ptr(), Y.data_ptr(),
            coords.data_ptr(), carry_rows.data_ptr(), carry_vals.data_ptr(),
            A.num_rows, A.nnz, num_tiles, L, stream)
    _build.check(rc, name)
    if f64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return Y


def merge_matmat(A: MergeDevice, X: torch.Tensor) -> torch.Tensor:
    """A @ X for X (num_cols, L) in the operand's type: K3 (float32) or
    K3d (float64) on a CUDA tensor, the plain version on a CPU tensor;
    any other device raises."""
    check_operands(A, X, "K3")
    if X.device.type == "cuda":
        return _launch(A, X)
    if X.device.type == "cpu":
        return spmm_merge_plain(A, X)
    raise ValueError(f"no K3 path for device {X.device}")


def scaled_product(matmat, A, X, alpha=1.0, beta=0.0, Y=None):
    """alpha * matmat(A, X) + beta * Y for X (num_cols, L), or
    (num_cols,) taken as L = 1 and given back 1-D; X is cast to the
    operand's value type."""
    squeeze = X.dim() == 1
    X2 = X.reshape(-1, 1) if squeeze else X
    Y_new = matmat(A, X2.to(A.values.dtype).contiguous())
    if squeeze:
        Y_new = Y_new[:, 0]
    if beta == 0.0 or Y is None:
        return alpha * Y_new
    return alpha * Y_new + beta * Y


def spmm_merge(A: MergeDevice, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y via K3, X (num_cols, L) or
    (num_cols,)."""
    return scaled_product(merge_matmat, A, X, alpha, beta, Y)
