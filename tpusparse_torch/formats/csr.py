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

from tpusparse_torch.utils import trace

INT32_MAX = 2**31 - 1

# The value types the port's plans hold, and their numpy types.
NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64}
VALUE_DTYPES = tuple(NUMPY_OF)


def value_dtype(dtype) -> torch.dtype:
    """The torch value type of a plan for ``dtype`` (a numpy or torch
    float32 or float64); raises TypeError for any other."""
    td = dtype
    if td is None:
        # np.dtype(None) is float64: a plan's None default is resolved by
        # host_value_dtype before it reaches here
        raise TypeError("dtype None: plans hold float32 or float64 values")
    if not isinstance(td, torch.dtype):
        td = {np.dtype(v): k for k, v in NUMPY_OF.items()}.get(
            np.dtype(dtype))
    if td not in NUMPY_OF:
        raise TypeError(f"dtype {dtype}: plans hold float32 or float64 "
                        "values")
    return td


def host_value_dtype(csr) -> torch.dtype:
    """The type of a ``dtype=None`` plan of ``csr``: its values' type, as
    the JAX package's ``np.asarray(csr.values).dtype``."""
    v = csr.values
    return value_dtype(v.dtype if isinstance(v, torch.Tensor)
                       else np.asarray(v).dtype)


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

    @classmethod
    def from_scipy(cls, m) -> "CsrMatrix":
        """From a scipy sparse matrix, with the columns of each row
        sorted (scipy's ``tocsr`` does not guarantee it)."""
        m = m.tocsr()
        if not m.has_sorted_indices:
            m = m.copy()
            m.sort_indices()
        return cls(m.shape[0], m.shape[1], m.indptr.astype(np.int32),
                   m.indices.astype(np.int32), m.data)

    def row_ids(self) -> np.ndarray:
        """The row of every stored entry, (nnz,) int32."""
        return np.repeat(np.arange(self.num_rows, dtype=np.int32),
                         np.diff(np.asarray(self.row_offsets)))

    def transpose(self) -> "CsrMatrix":
        """A^T by a stable sort on (column, row), as the JAX package's
        ``CsrMatrix.transpose``."""
        cols = np.asarray(self.col_indices)
        rows = self.row_ids()
        order = np.lexsort((rows, cols))
        offsets = np.zeros(self.num_cols + 1, dtype=np.int32)
        np.cumsum(np.bincount(cols, minlength=self.num_cols),
                  out=offsets[1:])
        return CsrMatrix(self.num_cols, self.num_rows, offsets,
                         rows[order].astype(np.int32),
                         np.asarray(self.values)[order])

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
        host = [np.ascontiguousarray(self.row_offsets, dtype=np.int32),
                np.ascontiguousarray(self.col_indices, dtype=np.int32),
                np.ascontiguousarray(self.values, dtype=NUMPY_OF[dtype])]
        with trace.span("plan.upload"):
            ro, ci, va = (torch.from_numpy(a).to(device) for a in host)
        return CsrMatrix(self.num_rows, self.num_cols, ro, ci, va)
