"""Merge-path CSR SpMV — kernel K2, its float64 twin K2d, and their plan.

Port of ``tpusparse/kernels/merge_spmv.py``. The TPU plan partitions the
nonzeros into equal-nnz (8, 128) tiles on the host
(``tpusparse/formats/tiles.py``) because the TPU kernel needs static
shapes; on the GPU the merge-path search runs on the device at every
call, so the plan is the CSR itself, on the device. The overflow stream
and span classes of the TPU plan have no counterpart.

K2 (``csrc/merge_spmv.cu``) replaces the Pallas kernel
``tpusparse/kernels/merge_spmv.py::_spmv_tiles``: search, consume and
fix-up kernels, with no float atomics, so two runs give bitwise equal y.
K2d, the same template at IEEE float64, replaces the double-float
(two-f32) kernel ``tpusparse/kernels/merge_df.py::_spmv_tiles_df``. A
kernel runs in the operand's value type: ``spmv_merge`` casts x to it,
and ``merge_matvec`` with x of another type raises TypeError.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.formats.csr import VALUE_DTYPES
from tpusparse_torch.kernels import _build
from tpusparse_torch.ops.reference import csr_matvec

# K2 launches since the count was last reset (plain runs not counted).
LAUNCHES = 0
# K2d (float64) launches, counted apart from K2's.
LAUNCHES_F64 = 0


@dataclasses.dataclass
class MergeDevice:
    """Merge-path SpMV operand: a CSR matrix on a device (int32 offsets
    and column indices, float32 or float64 values)."""

    num_rows: int
    num_cols: int
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])


def to_device_merge(csr, device, dtype=torch.float32) -> MergeDevice:
    """Merge plan of a host CsrMatrix: the CSR arrays on ``device``,
    values in ``dtype``."""
    d = csr.to(device, dtype)
    return MergeDevice(d.num_rows, d.num_cols, d.row_offsets,
                       d.col_indices, d.values)


def spmv_merge_plain(A: MergeDevice, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 and K2d: gather, multiply,
    ``index_add_``, in the values' dtype."""
    return csr_matvec(A.num_rows, A.row_offsets, A.col_indices, A.values, x)


def _check(A: MergeDevice, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.shape[0] != A.num_cols:
        raise ValueError(f"x must be ({A.num_cols},), got {tuple(x.shape)}")
    if A.values.dtype not in VALUE_DTYPES or x.dtype != A.values.dtype:
        raise TypeError(f"K2 takes x in its operand's type "
                        f"({A.values.dtype}), got {x.dtype}")
    if (A.row_offsets.dtype != torch.int32
            or A.col_indices.dtype != torch.int32):
        raise TypeError("K2 needs int32 row offsets and column indices")
    if (A.row_offsets.shape != (A.num_rows + 1,)
            or A.values.shape != A.col_indices.shape):
        raise ValueError("inconsistent CSR array shapes")
    if not all(t.is_contiguous() for t in
               (x, A.row_offsets, A.col_indices, A.values)):
        raise ValueError("K2 needs contiguous operands")
    if any(t.device != x.device for t in
           (A.row_offsets, A.col_indices, A.values)):
        raise ValueError(f"x on {x.device}, operand elsewhere: same device "
                         "needed")


def _launch(A: MergeDevice, x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F64
    lib = _build.library()
    tile = lib.tps_merge_tile_items()
    num_tiles = -(-(A.num_rows + A.nnz) // tile)
    dev = x.device
    y = torch.empty(A.num_rows, dtype=x.dtype, device=dev)
    if num_tiles == 0:
        return y
    coords = torch.empty((num_tiles + 1, 2), dtype=torch.int32, device=dev)
    carry_rows = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    carry_vals = torch.empty(num_tiles, dtype=x.dtype, device=dev)
    f64 = x.dtype == torch.float64
    name = "tps_merge_spmv_f64" if f64 else "tps_merge_spmv"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            A.row_offsets.data_ptr(), A.col_indices.data_ptr(),
            A.values.data_ptr(), x.data_ptr(), y.data_ptr(),
            coords.data_ptr(), carry_rows.data_ptr(), carry_vals.data_ptr(),
            A.num_rows, A.nnz, num_tiles, stream)
    _build.check(rc, name)
    if f64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return y


def merge_matvec(A: MergeDevice, x: torch.Tensor) -> torch.Tensor:
    """A @ x for x in the operand's type: K2 (float32) or K2d (float64)
    on a CUDA tensor, the plain version on a CPU tensor; any other device
    raises."""
    _check(A, x)
    if x.device.type == "cuda":
        return _launch(A, x)
    if x.device.type == "cpu":
        return spmv_merge_plain(A, x)
    raise ValueError(f"no K2 path for device {x.device}")


def spmv_merge(A: MergeDevice, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y via the merge-path kernel."""
    y_new = merge_matvec(A, x.to(A.values.dtype))
    if beta == 0.0 or y is None:
        return alpha * y_new
    return alpha * y_new + beta * y
