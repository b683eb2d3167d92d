"""Merge-path CSR SpMV — kernel K2, its float64 twin K2d, and their plan.

Port of ``tpusparse/kernels/merge_spmv.py``. The TPU plan partitions the
nonzeros into equal-nnz (8, 128) tiles on the host
(``tpusparse/formats/tiles.py``) because the TPU kernel needs static
shapes. Here the plan is the CSR itself on the device, plus the start
of every CTA tile on the merge path (``tile_coords``): where a tile
starts depends only on the matrix, so the plan finds it once, with a
numpy binary search (``merge_tile_coords``), and no call of K2 or of the
merge SpMM K3 (``spmm_merge.py``), which works on the same tiles,
searches again.
The overflow stream and span classes of the TPU plan have no
counterpart.

K2 (``csrc/merge_spmv.cu``) replaces the Pallas kernel
``tpusparse/kernels/merge_spmv.py::_spmv_tiles``: consume and fix-up
kernels, with no float atomics, so two runs give bitwise equal y. K2d,
the same template at IEEE float64, replaces the double-float (two-f32)
kernel ``tpusparse/kernels/merge_df.py::_spmv_tiles_df``. A kernel runs
in the operand's value type: the dispatch layer (``ops/spmv.py``) casts
x to it, and ``merge_matvec`` with x of another type raises TypeError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.formats.csr import VALUE_DTYPES
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.csr_reference import csr_matvec_plain
from tpusparse_torch.utils import trace

# the span of a launch, by value type
SPANS = {torch.float32: "kernel.K2", torch.float64: "kernel.K2d"}

# Merge items per CTA tile of K2 and K2d (kThreads * kItems in
# csrc/merge_spmv.cu, whose tps_merge_spmv_tile_items() must agree: every
# launch checks) and of K3 and K3d, which work on the same tiles.
TILE_ITEMS = 1024


def merge_tile_coords(row_offsets, nnz: int,
                      tile: int = TILE_ITEMS) -> np.ndarray:
    """(tiles + 1, 2) int32 (row, nonzero) at which each tile of ``tile``
    merge items starts, tiles = ceil((num_rows + nnz) / tile); the last
    entry is the end of the path, (num_rows, nnz).

    The merge path of a CSR matrix merges the row end offsets with the
    nonzero indices 0 .. nnz-1, a row end first where it is <= the
    nonzero index. Row i's end is thus item row_end[i] + i of the path,
    a strictly increasing key, and the rows consumed before diagonal d
    are the keys < d: one binary search per tile, in int64."""
    row_end = np.asarray(row_offsets, dtype=np.int64)[1:]
    total = row_end.shape[0] + int(nnz)
    tiles = -(-total // tile)
    diag = np.minimum(np.arange(tiles + 1, dtype=np.int64) * tile, total)
    keys = row_end + np.arange(row_end.shape[0], dtype=np.int64)
    rows = np.searchsorted(keys, diag, side="left")
    return np.stack([rows, diag - rows], axis=1).astype(np.int32)


@dataclasses.dataclass
class MergeDevice:
    """Merge-path SpMV and SpMM operand: a CSR matrix on a device (int32
    offsets and column indices, float32 or float64 values) and the start
    of every tile of ``TILE_ITEMS`` merge items (``merge_tile_coords``,
    on the same device), which K2 and K3 read. A plan without them serves
    the plain versions only: K2 and K3 refuse it."""

    num_rows: int
    num_cols: int
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor
    tile_coords: torch.Tensor | None = None

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])


def to_device_merge(csr, device, dtype=torch.float32) -> MergeDevice:
    """Merge plan of a host CsrMatrix: the CSR arrays on ``device``,
    values in ``dtype``, and K2's tile starts."""
    d = csr.to(device, dtype)
    coords = torch.from_numpy(merge_tile_coords(csr.row_offsets, csr.nnz))
    with trace.span("plan.upload"):
        coords = coords.to(device)
    return MergeDevice(d.num_rows, d.num_cols, d.row_offsets,
                       d.col_indices, d.values, coords)


def spmv_merge_plain(A: MergeDevice, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 and K2d: gather, multiply,
    ``index_add_``, in the values' dtype."""
    return csr_matvec_plain(A.num_rows, A.row_offsets, A.col_indices,
                            A.values, x)


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


def plan_tile_coords(A: MergeDevice, num_tiles: int,
                     kernel: str = "K2") -> torch.Tensor:
    """The plan's tile starts, checked against the library's tile, for a
    launch of K2 or K3 (``kernel``) over ``num_tiles`` tiles."""
    _build.geometry("tps_merge_spmv_tile_items", (), TILE_ITEMS, "K2",
                    "merge_spmv.py")
    C = A.tile_coords
    if C is None:
        raise ValueError(f"{kernel} needs the plan's tile_coords: build "
                         "the plan with to_device_merge")
    if (C.shape != (num_tiles + 1, 2) or C.dtype != torch.int32
            or C.device != A.values.device or not C.is_contiguous()):
        raise ValueError(
            f"tile_coords must be contiguous int32 ({num_tiles + 1}, 2) on "
            f"{A.values.device} for tiles of {TILE_ITEMS} items, got "
            f"{C.dtype} {tuple(C.shape)} on {C.device}")
    return C


def _launch(A: MergeDevice, x: torch.Tensor) -> torch.Tensor:
    num_tiles = -(-(A.num_rows + A.nnz) // TILE_ITEMS)
    coords = plan_tile_coords(A, num_tiles)
    dev = x.device
    y = torch.empty(A.num_rows, dtype=x.dtype, device=dev)
    if num_tiles == 0:
        return y
    carry_rows = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    carry_vals = torch.empty(num_tiles, dtype=x.dtype, device=dev)
    f64 = x.dtype == torch.float64
    _build.launch("tps_merge_spmv_f64" if f64 else "tps_merge_spmv",
                  "K2d" if f64 else "K2", dev, A.row_offsets.data_ptr(),
                  A.col_indices.data_ptr(), A.values.data_ptr(),
                  x.data_ptr(), y.data_ptr(), coords.data_ptr(),
                  carry_rows.data_ptr(), carry_vals.data_ptr(), A.num_rows,
                  A.nnz, num_tiles)
    return y


def merge_matvec(A: MergeDevice, x: torch.Tensor) -> torch.Tensor:
    """A @ x for x in the operand's type: K2 (float32) or K2d (float64)
    on a CUDA tensor, the plain version on a CPU tensor; any other device
    raises."""
    _check(A, x)
    if x.device.type == "cuda":
        with trace.span(SPANS[x.dtype]):
            return _launch(A, x)
    if x.device.type == "cpu":
        return spmv_merge_plain(A, x)
    raise ValueError(f"no K2 path for device {x.device}")
