"""COO (coordinate) sparse matrix — host-side numpy container.

Port of ``tpusparse/formats/coo.py``: construction, the stable
(row, col) sort, duplicate coalescing and conversion to CSR. The native
counting sort of the JAX package is left out; ``np.lexsort`` gives the
same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CooMatrix:
    """Coordinate-format sparse matrix (host-side, numpy)."""

    num_rows: int
    num_cols: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    def __post_init__(self):
        self.rows = np.asarray(self.rows)
        self.cols = np.asarray(self.cols)
        self.vals = np.asarray(self.vals)
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError(
                f"COO arrays must have equal shapes, got {self.rows.shape}, "
                f"{self.cols.shape}, {self.vals.shape}"
            )

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    def sorted_by_row(self) -> "CooMatrix":
        """Copy sorted by (row, col), stable; already-sorted input is
        returned as it is."""
        r, c = self.rows, self.cols
        if r.size == 0:
            return self
        if bool(((r[1:] > r[:-1]) | ((r[1:] == r[:-1])
                                     & (c[1:] >= c[:-1]))).all()):
            return self
        order = np.lexsort((c, r))
        return CooMatrix(self.num_rows, self.num_cols, r[order], c[order],
                         self.vals[order])

    def sum_duplicates(self) -> "CooMatrix":
        """Coalesce duplicate (row, col) entries by summation."""
        order = np.lexsort((self.cols, self.rows))
        r, c, v = self.rows[order], self.cols[order], self.vals[order]
        if r.size == 0:
            return self
        key_change = np.empty(r.size, dtype=bool)
        key_change[0] = True
        key_change[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        group = np.cumsum(key_change) - 1
        out_v = np.zeros(int(group[-1]) + 1, dtype=v.dtype)
        np.add.at(out_v, group, v)
        return CooMatrix(self.num_rows, self.num_cols, r[key_change],
                         c[key_change], out_v)

    def to_csr(self, sum_dups: bool = False):
        from tpusparse_torch.formats.csr import CsrMatrix

        return CsrMatrix.from_coo(self, sum_dups=sum_dups)
