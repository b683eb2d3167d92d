"""Carrying a JAX plan's state across to the port.

``plan_from_arrays(kind, arrays, device)`` turns the arrays of a
``tpusparse`` plan, taken out as numpy (``np.asarray``), into the
port's plan, so that both packages can run on the same operand:

  * ``"dia_masked"`` — a ``DiaStreamDevice`` in masked form:
    ``mask_b`` ((nb, R, 128) int32 blocks; the words past ``num_rows``
    are the zero pad and are dropped), ``offsets``, ``vals`` and
    ``shape``;
  * ``"dia"`` — a value-plane ``DiaDevice`` (K5) from a JAX
    ``DiaDevice``: ``data`` (K, num_rows), ``offsets`` and ``shape``;
  * ``"dia_planes"`` — a ``DiaDevice`` from the value-plane form of a
    JAX ``DiaStreamDevice``: ``data_b`` ((nb, K, R, 128), float32 or
    bf16), unblocked to (K, num_rows) as the JAX package does
    (``ops/dia.py:172-174``; the entries past ``num_rows`` are the zero
    pad and are dropped), ``offsets`` and ``shape``;
  * ``"csr"`` — a merge plan from ``row_offsets``, ``col_indices``,
    ``values`` and ``shape``;
  * ``"row_split"`` — a row-split plan (K4) from the same CSR arrays;
  * ``"ell"`` — a row-split plan rebuilt from a JAX ``DeviceEll``'s
    gather-job tiles: ``vals`` and ``local_cols`` (ntiles, J, 128),
    ``row_block`` (ntiles,), ``job_cblk`` (ntiles * J,) and ``shape``.
    Slot (t, j, lane) holds the entry at row ``row_block[t] * 128 +
    lane`` and column ``job_cblk[t * J + j] * 128 + local_cols[t, j,
    lane]``; entries are sorted by (row, column). A pad slot and an
    explicit zero both read 0 and are dropped alike, so the rebuilt CSR
    equals the original only for a matrix with no explicit zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.dia import DiaDevice
from tpusparse_torch.kernels.dia_stream import from_mask_words
from tpusparse_torch.kernels.ell_spmm import to_device_row_split
from tpusparse_torch.kernels.merge_spmv import to_device_merge

LANES = 128  # rows per row block and columns per column block of ELL


def plan_from_arrays(kind: str, arrays: dict, device):
    n_rows, n_cols = (int(s) for s in arrays["shape"])
    if kind == "dia_masked":
        words = np.asarray(arrays["mask_b"]).reshape(-1)
        if np.any(words[n_rows:] != 0):
            raise ValueError("mask words past num_rows must be the zero pad")
        return from_mask_words(n_rows, n_cols, arrays["offsets"],
                               arrays["vals"], words[:n_rows], device)
    if kind in ("dia", "dia_planes"):
        return _dia_of_planes(kind, arrays, n_rows, n_cols, device)
    if kind in ("csr", "row_split"):
        csr = CsrMatrix(n_rows, n_cols, np.asarray(arrays["row_offsets"]),
                        np.asarray(arrays["col_indices"]),
                        np.asarray(arrays["values"]))
        if kind == "csr":
            return to_device_merge(csr, device)
        return to_device_row_split(csr, device)
    if kind == "ell":
        return to_device_row_split(_csr_of_ell(arrays, n_rows, n_cols),
                                   device)
    raise ValueError(
        f"unknown plan kind {kind!r} (dia_masked, dia, dia_planes, csr, "
        "row_split, ell)")


def _dia_of_planes(kind, arrays, n_rows, n_cols, device) -> DiaDevice:
    """A ``DiaDevice`` from (K, n) planes or (nb, K, R, 128) blocks;
    float32 planes stay float32 and bf16 planes bf16, bit for bit."""
    offsets = tuple(int(o) for o in arrays["offsets"])
    if kind == "dia":
        data = _planes_tensor(arrays["data"])
    else:
        blocks = _planes_tensor(arrays["data_b"])
        planes = blocks.permute(1, 0, 2, 3).reshape(len(offsets), -1)
        if torch.any(planes[:, n_rows:] != 0):
            raise ValueError("plane entries past num_rows must be the zero "
                             "pad")
        data = planes[:, :n_rows]
    if data.shape != (len(offsets), n_rows):
        raise ValueError(f"planes of shape {tuple(data.shape)} for "
                         f"{len(offsets)} offsets and {n_rows} rows")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"planes are float32 or bf16, got {data.dtype}")
    return DiaDevice(n_rows, n_cols, offsets, data.contiguous().to(device))


def _planes_tensor(a) -> torch.Tensor:
    """A numpy plane array as a tensor; numpy holds bf16 as an
    extension type (``bfloat16``) that torch does not take, so its bits
    travel as int16."""
    a = np.array(a, order="C")       # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _csr_of_ell(arrays: dict, n_rows: int, n_cols: int) -> CsrMatrix:
    vals = np.asarray(arrays["vals"])
    ntiles, J, lanes = vals.shape
    lcols = np.asarray(arrays["local_cols"]).astype(np.int64)
    rows = (np.asarray(arrays["row_block"]).astype(np.int64)[:, None, None]
            * LANES + np.arange(lanes)[None, None, :])
    cblk = np.asarray(arrays["job_cblk"]).astype(np.int64).reshape(ntiles, J)
    cols = cblk[:, :, None] * LANES + lcols
    rows = np.broadcast_to(rows, vals.shape)
    keep = vals != 0
    r, c, v = rows[keep], cols[keep], vals[keep]
    if np.any(r >= n_rows) or np.any(c >= n_cols):
        raise ValueError("an ELL entry lies outside the matrix")
    order = np.lexsort((c, r))
    row_offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=row_offsets[1:])
    return CsrMatrix(n_rows, n_cols, row_offsets, c[order], v[order])
