"""BCSR (blocked CSR) sparse matrix: a host numpy container with
``to(device, dtype)``.

Port of ``tpusparse/formats/bcsr.py``, the reference's ``BcsrMatrix``
(multi-DOF FEM blocks): CSR -> BCSR by a two-pass count and fill, dense
blocks stored row-major within the block, rectangular blocks, and the
matrix implicitly zero-padded to block multiples at its edges. The
arrays equal the JAX package's for the same input. ``to(device, dtype)``
gives the operand of kernels K8 and K8d (``kernels/bsr.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import NUMPY_OF, value_dtype
from tpusparse_torch.utils import trace


def fill_estimate(csr, block_rows: int = 8, block_cols: int = 128) -> float:
    """Blocking fill ratio without building the blocks: nnz over the
    dense capacity of the touched (block_rows x block_cols) tiles."""
    nnz = csr.nnz
    if nnz == 0:
        return 0.0
    ci = np.asarray(csr.col_indices).astype(np.int64)
    rows = csr.row_ids()
    key = (rows // block_rows) * ((csr.num_cols // block_cols) + 1) \
        + ci // block_cols
    num_blocks = np.unique(key).size
    return nnz / (num_blocks * block_rows * block_cols)


@dataclasses.dataclass
class BcsrMatrix:
    """Blocked-CSR matrix: dense (block_rows x block_cols) blocks in CSR
    block layout. ``block_row_offsets`` (num_block_rows + 1,) and
    ``block_col_indices`` (num_blocks,) int32, ``blocks`` (num_blocks,
    block_rows, block_cols); numpy on the host, torch tensors after
    ``to(device)``. ``num_rows`` and ``num_cols`` are the unpadded
    dimensions."""

    num_rows: int
    num_cols: int
    block_rows: int
    block_cols: int
    block_row_offsets: Any
    block_col_indices: Any
    blocks: Any

    @property
    def num_blocks(self) -> int:
        return int(self.block_col_indices.shape[0])

    @property
    def num_block_rows(self) -> int:
        return -(-self.num_rows // self.block_rows)

    @property
    def num_block_cols(self) -> int:
        return -(-self.num_cols // self.block_cols)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @property
    def fill_ratio(self) -> float:
        """Fraction of stored block entries that are nonzero."""
        total = int(np.prod(self.blocks.shape))
        return int((self.blocks != 0).sum()) / total if total else 0.0

    @classmethod
    def from_csr(cls, csr, block_rows: int = 8,
                 block_cols: int = 128) -> "BcsrMatrix":
        """Two-pass count and fill (the reference's ``BcsrMatrix::Init``),
        with rectangular blocks and implicit zero padding of the edges."""
        ci = np.asarray(csr.col_indices)
        va = np.asarray(csr.values)
        rows = csr.row_ids()
        brow = rows // block_rows
        bcol = ci // block_cols
        # pass 1: the sorted unique (block row, block column) pairs
        key = brow.astype(np.int64) * ((csr.num_cols // block_cols) + 1) \
            + bcol
        order = np.argsort(key, kind="stable")
        sk = key[order]
        new_block = np.empty(sk.size, dtype=bool)
        if sk.size:
            new_block[0] = True
            new_block[1:] = sk[1:] != sk[:-1]
        block_id = np.cumsum(new_block) - 1 if sk.size else new_block
        num_blocks = int(block_id[-1]) + 1 if sk.size else 0
        blk_brow = brow[order][new_block] if sk.size else np.zeros(0, np.int32)
        blk_bcol = bcol[order][new_block] if sk.size else np.zeros(0, np.int32)
        # pass 2: fill the dense blocks
        blocks = np.zeros((num_blocks, block_rows, block_cols), dtype=va.dtype)
        lr = (rows[order] % block_rows).astype(np.int64)
        lc = (ci[order] % block_cols).astype(np.int64)
        np.add.at(blocks, (block_id, lr, lc), va[order])
        nbr = -(-csr.num_rows // block_rows)
        offs = np.zeros(nbr + 1, dtype=np.int32)
        np.cumsum(np.bincount(blk_brow, minlength=nbr), out=offs[1:])
        return cls(csr.num_rows, csr.num_cols, block_rows, block_cols, offs,
                   blk_bcol.astype(np.int32), blocks)

    def to_csr(self):
        """Expand back to CSR, dropping the explicit zeros of the block
        padding."""
        from tpusparse_torch.formats.coo import CooMatrix

        blocks = np.asarray(self.blocks)
        bro = np.asarray(self.block_row_offsets)
        bci = np.asarray(self.block_col_indices)
        blk_brow = np.repeat(np.arange(self.num_block_rows, dtype=np.int64),
                             np.diff(bro))
        bidx, lr, lc = np.nonzero(blocks)
        r = blk_brow[bidx] * self.block_rows + lr
        c = bci[bidx].astype(np.int64) * self.block_cols + lc
        keep = (r < self.num_rows) & (c < self.num_cols)
        return CooMatrix(self.num_rows, self.num_cols,
                         r[keep].astype(np.int32), c[keep].astype(np.int32),
                         blocks[bidx[keep], lr[keep], lc[keep]]).to_csr()

    def to(self, device, dtype=torch.float32) -> "BcsrMatrix":
        """The same matrix as torch tensors on ``device``: int32 block
        offsets and block-column indices, blocks in ``dtype`` (float32, or
        float64, which keeps float64 host values unrounded)."""
        dtype = value_dtype(dtype)

        host = [np.array(self.block_row_offsets, dtype=np.int32, order="C"),
                np.array(self.block_col_indices, dtype=np.int32, order="C"),
                np.array(self.blocks, dtype=NUMPY_OF[dtype], order="C")]
        with trace.span("plan.upload"):
            offsets, cols, blocks = (torch.from_numpy(a).to(device)
                                     for a in host)
        return BcsrMatrix(self.num_rows, self.num_cols, self.block_rows,
                          self.block_cols, offsets, cols, blocks)
