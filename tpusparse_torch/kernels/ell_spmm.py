"""Row-split CSR SpMM — kernel K4, its float64 twin K4d, and their plan.

Port of ``tpusparse/kernels/ell_spmm.py``, the row-splitting strategy
(``strategy='row_split'``, aliases ``'ell'`` and ``'simple'``). The TPU
plan packs the rows into 128-lane gather-job tiles
(``tpusparse/formats/ell.py``) because its kernel needs one entry per
vector lane; on the GPU a group of threads takes a row, so the plan is
the CSR itself on the device (``RowSplitDevice``), and neither the job
packing nor the TPU wrapper's refusal of matrices whose RHS block would
not fit VMEM has a counterpart.

K4 (``csrc/rowsplit_spmm.cu``) replaces the Pallas kernel
``tpusparse/kernels/ell_spmm.py::_spmm_ell``: each row's thread group
walks the row in CSR order, one RHS lane per thread, and writes each
output once, so two runs give bitwise equal Y. K4d, the same template
at IEEE float64, replaces the double-float (two-f32) kernel
``tpusparse/kernels/ell_df.py::_spmm_ell_df``; X is cast to the
operand's value type, as for K3.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.spmm_merge import check_operands, scaled_product
from tpusparse_torch.ops.reference import csr_matmat

# K4 launches since the count was last reset (plain runs not counted).
LAUNCHES = 0
# K4d (float64) launches, counted apart from K4's.
LAUNCHES_F64 = 0


@dataclasses.dataclass
class RowSplitDevice:
    """Row-split operand: a CSR matrix on a device (int32 offsets and
    column indices, float32 or float64 values)."""

    num_rows: int
    num_cols: int
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])


def to_device_row_split(csr, device, dtype=torch.float32) -> RowSplitDevice:
    """Row-split plan of a host CsrMatrix: the CSR arrays on ``device``,
    values in ``dtype``."""
    d = csr.to(device, dtype)
    return RowSplitDevice(d.num_rows, d.num_cols, d.row_offsets,
                          d.col_indices, d.values)


def spmm_row_split_plain(A: RowSplitDevice, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 and K4d: the same gather, multiply
    and per-row ``index_add_`` as K3's, in row order."""
    return csr_matmat(A.num_rows, A.row_offsets, A.col_indices, A.values, X)


def _launch(A: RowSplitDevice, X: torch.Tensor) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F64
    lib = _build.library()
    L = X.shape[1]
    Y = torch.empty((A.num_rows, L), dtype=X.dtype, device=X.device)
    if A.num_rows == 0:
        return Y
    f64 = X.dtype == torch.float64
    name = "tps_rowsplit_spmm_f64" if f64 else "tps_rowsplit_spmm"
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = getattr(lib, name)(
            A.row_offsets.data_ptr(), A.col_indices.data_ptr(),
            A.values.data_ptr(), X.data_ptr(), Y.data_ptr(), A.num_rows, L,
            stream)
    _build.check(rc, name)
    if f64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return Y


def row_split_matmat(A: RowSplitDevice, X: torch.Tensor) -> torch.Tensor:
    """A @ X for X (num_cols, L) in the operand's type: K4 (float32) or
    K4d (float64) on a CUDA tensor, the plain version on a CPU tensor;
    any other device raises."""
    check_operands(A, X, "K4")
    if X.device.type == "cuda":
        return _launch(A, X)
    if X.device.type == "cpu":
        return spmm_row_split_plain(A, X)
    raise ValueError(f"no K4 path for device {X.device}")


def spmm_ell(A: RowSplitDevice, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y via K4, X (num_cols, L) or
    (num_cols,)."""
    return scaled_product(row_split_matmat, A, X, alpha, beta, Y)


def spmv_ell(A: RowSplitDevice, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y: K4 at L = 1."""
    return spmm_ell(A, x, alpha=alpha, beta=beta, Y=y)
