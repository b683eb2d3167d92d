"""Row-split CSR SpMM — kernel K4, its float64 twin K4d, and their plan.

Port of ``tpusparse/kernels/ell_spmm.py``, the row-splitting strategy
(``strategy='row_split'``, aliases ``'ell'`` and ``'simple'``). The TPU
plan packs the rows into 128-lane gather-job tiles
(``tpusparse/formats/ell.py``) because its kernel needs one entry per
vector lane. Here the plan is the CSR itself on the device
(``RowSplitDevice``) and a table of work rows (``WorkRows``) built on
the host from the row offsets. That table replaces the gather-job tiles
and has nothing of their 128-lane packing; neither has the TPU
wrapper's refusal of matrices whose RHS block would not fit VMEM a
counterpart.

The table:

  * **work rows**: a row of at most ``ROW_CHUNK`` (C) nonzeros is one
    work row; a longer row is cut into ceil(len / C) consecutive chunks
    of C nonzeros (the last may be shorter), each a work row owned by
    that row. ``work_offsets`` is a virtual CSR over the same
    ``col_indices`` and ``values``; ``work_dest`` is a whole row's
    index, or ``~slot`` for a chunk, whose partial sum goes to row
    ``slot`` of a (chunks, L) workspace. One thread group of the kernel
    takes one work row;
  * **split rows**: ``split_rows`` and ``split_offsets`` give each cut
    row and its chunks' first partial slot (a CSR over the slots).

K4 (``csrc/rowsplit_spmm.cu``) replaces the Pallas kernel
``tpusparse/kernels/ell_spmm.py::_spmm_ell``; K4d, the same template at
IEEE float64, replaces the double-float (two-f32) kernel
``tpusparse/kernels/ell_df.py::_spmm_ell_df``. X is cast to the
operand's value type, as for K3.

The numerical contract. A row of length <= C is summed in one pass in
CSR order, each product and sum rounded apart. A split row is each
chunk summed so, then the chunk partials summed in chunk order (a
second kernel, launched only when the plan has split rows). The plain
version follows the same order (``csr_matmat_plain`` over the work
rows, then ``index_add_`` of the partials by owner, which runs in chunk
order on the CPU), so the kernel equals it run on the CPU bit for bit on every
row; two runs give bitwise equal Y (no float atomics). Every row stays
within ``|Y - AX| <= (nnz_i + 2) u (|A||X|)_i`` of the exact product:
a split row's error constant is at most C + ceil(nnz_i / C) <= nnz_i + 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.csr_reference import csr_matmat_plain
from tpusparse_torch.kernels.spmm_merge import check_operands
from tpusparse_torch.utils import trace

# C: the most nonzeros one thread group walks (a longer row is cut);
# 256 of {256, 512, 1024} on the H100 (PERF.md §6).
ROW_CHUNK = 256

# the span of a launch, by value type
SPANS = {torch.float32: "kernel.K4", torch.float64: "kernel.K4d"}


@dataclasses.dataclass
class WorkRows:
    """Work rows of a row-split plan (module docstring): int32 tensors on
    the plan's device, and the number of chunks."""

    num_chunks: int
    work_offsets: torch.Tensor
    work_dest: torch.Tensor
    split_rows: torch.Tensor
    split_offsets: torch.Tensor

    @property
    def num_work_rows(self) -> int:
        return int(self.work_dest.shape[0])

    @property
    def num_split(self) -> int:
        return int(self.split_rows.shape[0])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.work_offsets, self.work_dest, self.split_rows,
                self.split_offsets)


@dataclasses.dataclass
class RowSplitDevice:
    """Row-split operand: a CSR matrix on a device (int32 offsets and
    column indices, float32 or float64 values) and its ``WorkRows``
    (``to_device_row_split`` builds both)."""

    num_rows: int
    num_cols: int
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor
    table: WorkRows | None = None

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])


def work_rows(row_offsets) -> dict:
    """The work-row table of CSR ``row_offsets`` (host numpy, O(n)):
    ``work_offsets``, ``work_dest``, ``split_rows``, ``split_offsets``
    (int32 arrays) and ``num_chunks``."""
    ro = np.asarray(row_offsets, dtype=np.int64)
    n = ro.shape[0] - 1
    lengths = np.diff(ro)
    pieces = np.maximum(1, -(-lengths // ROW_CHUNK))  # work rows per row
    first = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(pieces, out=first[1:])
    num_work = int(first[-1])
    owner = np.repeat(np.arange(n, dtype=np.int64), pieces)
    k = np.arange(num_work, dtype=np.int64) - first[owner]
    work_offsets = np.empty(num_work + 1, dtype=np.int64)
    work_offsets[:num_work] = ro[owner] + k * ROW_CHUNK
    work_offsets[num_work] = ro[n]
    # a chunk's partial slot is its rank among the chunks, so the slots
    # of one split row are consecutive and in chunk order
    is_chunk = pieces[owner] > 1
    num_chunks = int(np.count_nonzero(is_chunk))
    work_dest = owner.copy()
    work_dest[is_chunk] = ~np.arange(num_chunks, dtype=np.int64)
    split = np.flatnonzero(pieces > 1)
    split_offsets = np.zeros(split.shape[0] + 1, dtype=np.int64)
    np.cumsum(pieces[split], out=split_offsets[1:])
    i32 = np.int32
    return {"work_offsets": work_offsets.astype(i32),
            "work_dest": work_dest.astype(i32),
            "split_rows": split.astype(i32),
            "split_offsets": split_offsets.astype(i32),
            "num_chunks": num_chunks}


def to_device_row_split(csr, device, dtype=torch.float32) -> RowSplitDevice:
    """Row-split plan of a host CsrMatrix: the CSR arrays on ``device``,
    values in ``dtype``, and their ``WorkRows``."""
    d = csr.to(device, dtype)
    t = work_rows(csr.row_offsets)
    num_chunks = t.pop("num_chunks")
    with trace.span("plan.upload"):
        table = WorkRows(num_chunks, **{k: torch.from_numpy(v).to(device)
                                        for k, v in t.items()})
    return RowSplitDevice(d.num_rows, d.num_cols, d.row_offsets,
                          d.col_indices, d.values, table)


def _table_of(A: RowSplitDevice, X: torch.Tensor) -> WorkRows:
    """The operand's ``WorkRows``, checked against X: int32, contiguous,
    on X's device."""
    B = A.table
    if B is None:
        raise ValueError("K4 needs the plan's work-row table: build the "
                         "operand with to_device_row_split")
    if any(t.dtype != torch.int32 or not t.is_contiguous()
           or t.device != X.device for t in B.tensors()):
        raise ValueError("K4's work-row table must be contiguous int32 on "
                         f"{X.device}")
    return B


def _work_row_owners(B: WorkRows) -> torch.Tensor:
    """The row each work row sums into, (work rows,) int64, for a table
    with split rows."""
    dest = B.work_dest.to(torch.int64)
    counts = (B.split_offsets[1:] - B.split_offsets[:-1]).to(torch.int64)
    slot_owner = torch.repeat_interleave(B.split_rows.to(torch.int64),
                                         counts, output_size=B.num_chunks)
    return torch.where(dest >= 0, dest, slot_owner[(~dest).clamp(min=0)])


def spmm_row_split_plain(A: RowSplitDevice, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 and K4d, in the kernels' order: K3's
    gather, multiply and per-row ``index_add_`` over the work rows, then
    the partials of each split row added into it by ``index_add_``."""
    B = _table_of(A, X)
    Yw = csr_matmat_plain(B.num_work_rows, B.work_offsets, A.col_indices,
                          A.values, X)
    if B.num_chunks == 0:
        return Yw
    Y = torch.zeros((A.num_rows, X.shape[1]), dtype=Yw.dtype,
                    device=Yw.device)
    return Y.index_add_(0, _work_row_owners(B), Yw)


def _launch(A: RowSplitDevice, X: torch.Tensor) -> torch.Tensor:
    B = _table_of(A, X)
    L = X.shape[1]
    Y = torch.empty((A.num_rows, L), dtype=X.dtype, device=X.device)
    if A.num_rows == 0:
        return Y
    partials = torch.empty((B.num_chunks, L), dtype=X.dtype,
                           device=X.device)
    f64 = X.dtype == torch.float64
    _build.launch("tps_rowsplit_spmm_f64" if f64 else "tps_rowsplit_spmm",
                  "K4d" if f64 else "K4", X.device,
                  B.work_offsets.data_ptr(), B.work_dest.data_ptr(),
                  A.col_indices.data_ptr(), A.values.data_ptr(),
                  X.data_ptr(), Y.data_ptr(), partials.data_ptr(),
                  B.split_rows.data_ptr(), B.split_offsets.data_ptr(),
                  B.num_work_rows, B.num_split, L)
    return Y


def row_split_matmat(A: RowSplitDevice, X: torch.Tensor) -> torch.Tensor:
    """A @ X for X (num_cols, L) in the operand's type: K4 (float32) or
    K4d (float64) on a CUDA tensor, the plain version on a CPU tensor;
    any other device raises."""
    check_operands(A, X, "K4")
    if X.device.type == "cuda":
        with trace.span(SPANS[X.dtype]):
            return _launch(A, X)
    if X.device.type == "cpu":
        return spmm_row_split_plain(A, X)
    raise ValueError(f"no K4 path for device {X.device}")
