"""BCSR panel SpMM — kernel K8 and its float64 twin K8d.

Port of ``tpusparse/kernels/bsr.py``. The operand is a ``BcsrMatrix``
on the device (``formats/bcsr.py``, ``to(device, dtype)``): dense
(br, bc) blocks, each contributing a (br, bc) x (bc, L) panel product to
the (br, L) panel of its block row.

K8 (``csrc/bsr.cu``) replaces the Pallas kernel
``_bsr_spmm_panels_static`` (body ``_bsr_kernel``), which multiplies at
``Precision.HIGHEST``: K8 works and accumulates in float32 FMA, with no
TF32 and no tensor cores. K8d, the same template at IEEE float64,
replaces the JAX package's float64 product (XLA's einsum and segment
sum: there is no Pallas kernel). The TPU kernel's tiling rule (br a
multiple of 8, bc of 128) and its XLA fallback for other blocks have no
counterpart: K8 takes any (br, bc) within ``MAX_BLOCK_ENTRIES``, and
its lane padding of X to a multiple of 8 goes. Both kernels sum each
row in a fixed order, so two runs give bitwise equal Y.

The plain version (gather the X panels, batched products, sum per block
row) serves CPU tensors only: a CUDA tensor launches K8 or K8d or
raises.
"""

from __future__ import annotations

import torch

from tpusparse_torch.formats.bcsr import BcsrMatrix
from tpusparse_torch.formats.csr import VALUE_DTYPES
from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import trace

# K8 takes blocks of up to this many entries (br * bc); each thread's dot
# product runs over at most bc of them per block.
MAX_BLOCK_ENTRIES = 1 << 20

# the span of a launch, by value type
SPANS = {torch.float32: "kernel.K8", torch.float64: "kernel.K8d"}


def block_row_ids(A: BcsrMatrix) -> torch.Tensor:
    """The block row of every block, (num_blocks,) int64 (the output size
    given, so no host sync: the plain version can be graph-captured)."""
    counts = (A.block_row_offsets[1:] - A.block_row_offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(A.num_block_rows, device=counts.device), counts,
        output_size=A.num_blocks)


def bsr_spmm_plain(A: BcsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8 and K8d: gather each block's X panel
    (zero past num_cols), batched (br, bc) x (bc, L) products, summed per
    block row, in X's dtype."""
    br, bc, L = A.block_rows, A.block_cols, X.shape[1]
    Xp = torch.zeros((A.num_block_cols * bc, L), dtype=X.dtype,
                     device=X.device)
    Xp[:A.num_cols] = X
    Xg = Xp.view(A.num_block_cols, bc, L).index_select(
        0, A.block_col_indices.long())
    contrib = torch.bmm(A.blocks, Xg)
    Y = torch.zeros((A.num_block_rows, br, L), dtype=X.dtype,
                    device=X.device)
    Y.index_add_(0, block_row_ids(A), contrib)
    return Y.reshape(-1, L)[:A.num_rows]


def _check(A: BcsrMatrix, X: torch.Tensor) -> None:
    nb, br, bc = A.num_blocks, A.block_rows, A.block_cols
    if X.dim() != 2 or X.shape[0] != A.num_cols or X.shape[1] < 1:
        raise ValueError(
            f"X must be ({A.num_cols}, L >= 1), got {tuple(X.shape)}")
    if A.blocks.dtype not in VALUE_DTYPES or X.dtype != A.blocks.dtype:
        raise TypeError(f"K8 takes X in its operand's type "
                        f"({A.blocks.dtype}), got {X.dtype}")
    if (A.block_row_offsets.dtype != torch.int32
            or A.block_col_indices.dtype != torch.int32):
        raise TypeError("K8 needs int32 block offsets and block columns")
    if (A.block_row_offsets.shape != (A.num_block_rows + 1,)
            or A.blocks.shape != (nb, br, bc)):
        raise ValueError("inconsistent BCSR array shapes")
    if br < 1 or bc < 1 or br * bc > MAX_BLOCK_ENTRIES:
        raise ValueError(f"K8 takes blocks of 1 to {MAX_BLOCK_ENTRIES} "
                         f"entries, got ({br}, {bc})")
    if not all(t.is_contiguous() for t in
               (X, A.block_row_offsets, A.block_col_indices, A.blocks)):
        raise ValueError("K8 needs contiguous operands")
    if any(t.device != X.device for t in
           (A.block_row_offsets, A.block_col_indices, A.blocks)):
        raise ValueError(f"X on {X.device}, operand elsewhere: same device "
                         "needed")


def _launch(A: BcsrMatrix, X: torch.Tensor) -> torch.Tensor:
    L = X.shape[1]
    Y = torch.empty((A.num_rows, L), dtype=X.dtype, device=X.device)
    if A.num_rows == 0:
        return Y
    f64 = X.dtype == torch.float64
    _build.launch("tps_bsr_f64" if f64 else "tps_bsr", "K8d" if f64 else "K8",
                  X.device, A.block_row_offsets.data_ptr(),
                  A.block_col_indices.data_ptr(), A.blocks.data_ptr(),
                  X.data_ptr(), Y.data_ptr(), A.num_rows, A.num_cols,
                  A.num_block_rows, A.block_rows, A.block_cols, L)
    return Y


def bsr_matmat(A: BcsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """A @ X for X (num_cols, L) in the operand's type: K8 (float32) or
    K8d (float64) on a CUDA tensor, the plain version on a CPU tensor;
    any other device raises."""
    _check(A, X)
    if X.device.type == "cuda":
        with trace.span(SPANS[X.dtype]):
            return _launch(A, X)
    if X.device.type == "cpu":
        return bsr_spmm_plain(A, X)
    raise ValueError(f"no K8 path for device {X.device}")
