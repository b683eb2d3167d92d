"""CSR sparse matrix: a host numpy container with ``to(device)``.

Port of ``tpusparse/formats/csr.py``. The arrays are numpy on the host;
``to(device, dtype)`` gives the same matrix as torch tensors (int32
``row_offsets`` and ``col_indices``, float32 or float64 ``values``),
which is the operand of the ``reference`` strategy and the source of the
merge and row-split plans.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

INT32_MAX = 2**31 - 1

# The value types the port's plans hold, and their numpy types.
NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64}
VALUE_DTYPES = tuple(NUMPY_OF)


def value_dtype(dtype) -> torch.dtype:
    """The torch value type of a plan for ``dtype`` (a numpy or torch
    float32 or float64); raises TypeError for any other."""
    td = dtype
    if not isinstance(td, torch.dtype):
        td = {np.dtype(v): k for k, v in NUMPY_OF.items()}.get(
            np.dtype(dtype))
    if td not in NUMPY_OF:
        raise TypeError(f"dtype {dtype}: plans hold float32 or float64 "
                        "values")
    return td


@dataclasses.dataclass
class CsrMatrix:
    """Compressed Sparse Row matrix.

    ``row_offsets`` (num_rows + 1,): row i occupies
    ``[row_offsets[i], row_offsets[i+1])`` of the nnz streams.
    ``col_indices`` (nnz,): non-decreasing within each row.
    ``values`` (nnz,). numpy arrays on the host, torch tensors after
    ``to(device)``."""

    num_rows: int
    num_cols: int
    row_offsets: Any
    col_indices: Any
    values: Any

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @classmethod
    def from_coo(cls, coo, sum_dups: bool = False) -> "CsrMatrix":
        """Build from a CooMatrix with a stable (row, col) sort;
        duplicates are kept unless ``sum_dups``."""
        coo = coo.sum_duplicates() if sum_dups else coo.sorted_by_row()
        counts = np.bincount(coo.rows, minlength=coo.num_rows)
        row_offsets = np.zeros(coo.num_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=row_offsets[1:])
        return cls(coo.num_rows, coo.num_cols, row_offsets,
                   np.ascontiguousarray(coo.cols, dtype=np.int32),
                   np.ascontiguousarray(coo.vals))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(self.values), np.asarray(self.col_indices),
             np.asarray(self.row_offsets)),
            shape=self.shape,
        )

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(self.num_rows, self.num_cols, self.row_offsets,
                         self.col_indices, self.values.astype(dtype))

    def to(self, device, dtype=torch.float32) -> "CsrMatrix":
        """The same matrix as torch tensors on ``device``: int32 offsets
        and column indices, values in ``dtype`` (float32, or float64,
        which keeps float64 host values unrounded). Raises when nnz does
        not fit int32 offsets."""
        dtype = value_dtype(dtype)
        if self.nnz > INT32_MAX:
            raise ValueError(
                f"nnz={self.nnz} does not fit int32 row offsets (< 2^31)")
        if max(self.num_rows, self.num_cols) > INT32_MAX:
            raise ValueError("dimensions must fit int32")
        ro = np.asarray(self.row_offsets, dtype=np.int32)
        ci = np.asarray(self.col_indices, dtype=np.int32)
        va = np.asarray(self.values, dtype=NUMPY_OF[dtype])
        return CsrMatrix(
            self.num_rows, self.num_cols,
            torch.from_numpy(np.ascontiguousarray(ro)).to(device),
            torch.from_numpy(np.ascontiguousarray(ci)).to(device),
            torch.from_numpy(np.ascontiguousarray(va)).to(device),
        )
