"""Merge-path CSR SpMM — kernel K3 and its float64 twin K3d.

Port of ``tpusparse/kernels/spmm_merge.py``. The operand is K2's merge
plan (``merge_spmv.MergeDevice``, the CSR on the device and the start of
every tile on the merge path): one plan serves SpMV (K2) and SpMM (K3),
as the JAX package's merge tiles serve both of its kernels.

K3 (``csrc/merge_spmm.cu``) replaces the Pallas kernel
``tpusparse/kernels/spmm_merge.py::_spmm_tiles``: a consume kernel with
the RHS lanes inside each CTA, so the matrix payload streams once for
all L lanes, on the plan's tiles (K2's), and a fix-up kernel; a call
launches these two and searches nothing. A thread takes 16 bytes of
lanes (four float32, two float64) where they divide L. No float
atomics, so two runs give bitwise equal Y. The TPU wrapper's lane
padding to multiples of 8, its VMEM lane chunks and its overflow COO
stream have no counterpart. K3d, the same template at IEEE float64,
replaces the double-float (two-f32) kernel
``tpusparse/kernels/merge_df.py::_spmm_tiles_df``. A kernel runs in the
operand's value type: the dispatch layer (``ops/spmv.py``) casts X to
it, and a kernel-level call with X of another type raises TypeError.

The order of a lane's additions follows K3's geometry: a CTA of
``BLOCK_THREADS`` threads walks a tile in groups, each group one
stretch of ``group_items(L, itemsize)`` merge items (``group_items``
mirrors the library's ``tps_merge_spmm_group_items``, and every launch
checks that the two agree).
"""

from __future__ import annotations

import torch

from tpusparse_torch.formats.csr import VALUE_DTYPES
from tpusparse_torch.kernels import _build, merge_spmv
from tpusparse_torch.kernels.csr_reference import csr_matmat_plain
from tpusparse_torch.kernels.merge_spmv import MergeDevice
from tpusparse_torch.utils import trace

# the span of a launch, by value type
SPANS = {torch.float32: "kernel.K3", torch.float64: "kernel.K3d"}

# K3's geometry, mirrored from csrc/merge_spmm.cu: threads per consume
# CTA (kBlock), threads per lane group, at most (kMaxGroup), and the bytes
# of RHS lanes a thread takes where they divide L (kLaneBytes).
BLOCK_THREADS = 128
MAX_GROUP = 32
LANE_BYTES = 16


def lanes_per_thread(L: int, itemsize: int) -> int:
    """RHS lanes a thread of K3 takes: LANE_BYTES of them (4 in
    float32, 2 in float64) where they divide L, else one."""
    wide = LANE_BYTES // itemsize
    return wide if L % wide == 0 else 1


def group_items(L: int, itemsize: int) -> int:
    """Merge items of each lane group's stretch of a tile at L
    right-hand sides of ``itemsize`` bytes: the CTA's threads form groups
    of W threads (W the next power of two >= L / lanes_per_thread, at
    most MAX_GROUP), and each group walks TILE_ITEMS / (BLOCK_THREADS /
    W) consecutive items of the tile. The stretches fix the order of
    every lane's additions."""
    lanes = -(-L // lanes_per_thread(L, itemsize))
    w = 1
    while w < lanes and w < MAX_GROUP:
        w *= 2
    return merge_spmv.TILE_ITEMS // (BLOCK_THREADS // w)


def spmm_merge_plain(A: MergeDevice, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 and K3d: gather the rows of X,
    multiply, ``index_add_`` per row, in the values' dtype."""
    return csr_matmat_plain(A.num_rows, A.row_offsets, A.col_indices,
                            A.values, X)


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
    L = X.shape[1]
    num_tiles = -(-(A.num_rows + A.nnz) // merge_spmv.TILE_ITEMS)
    coords = merge_spmv.plan_tile_coords(A, num_tiles, "K3")
    _build.geometry("tps_merge_spmm_group_items", (L, X.element_size()),
                    group_items(L, X.element_size()), "K3", "spmm_merge.py")
    dev = X.device
    Y = torch.empty((A.num_rows, L), dtype=X.dtype, device=dev)
    if num_tiles == 0:
        return Y
    carry_vals = torch.empty((num_tiles, L), dtype=X.dtype, device=dev)
    if X.data_ptr() % LANE_BYTES:
        X = X.clone()  # wide lanes load X in aligned LANE_BYTES words
    f64 = X.dtype == torch.float64
    _build.launch("tps_merge_spmm_f64" if f64 else "tps_merge_spmm",
                  "K3d" if f64 else "K3", dev, A.row_offsets.data_ptr(),
                  A.col_indices.data_ptr(), A.values.data_ptr(),
                  X.data_ptr(), Y.data_ptr(), coords.data_ptr(),
                  carry_vals.data_ptr(), A.num_rows, A.nnz, num_tiles, L)
    return Y


def merge_matmat(A: MergeDevice, X: torch.Tensor) -> torch.Tensor:
    """A @ X for X (num_cols, L) in the operand's type: K3 (float32) or
    K3d (float64) on a CUDA tensor, the plain version on a CPU tensor;
    any other device raises."""
    check_operands(A, X, "K3")
    if X.device.type == "cuda":
        with trace.span(SPANS[X.dtype]):
            return _launch(A, X)
    if X.device.type == "cpu":
        return spmm_merge_plain(A, X)
    raise ValueError(f"no K3 path for device {X.device}")
