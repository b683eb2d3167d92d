"""Carrying a JAX plan's state across to the port.

``plan_from_arrays(kind, arrays, device, dtype=None)`` turns the arrays
of a ``tpusparse`` plan, taken out as numpy (``np.asarray``), into the
port's plan, so that both packages can run on the same operand.
``dtype`` (float32 or float64) is the value type of the port's plan; by
default a double-float kind gives float64, a plane kind keeps its
planes' type, and every other kind gives float32 (the JAX plans' own
type; a JAX host CSR holds float64 values even for a float32 plan):

  * ``"dia_masked"`` — a ``DiaStreamDevice`` in masked form:
    ``mask_b`` ((nb, R, 128) int32 blocks; the words past ``num_rows``
    are the zero pad and are dropped), ``offsets``, ``vals`` and
    ``shape``;
  * ``"dia_masked_df"`` — the same from the masked form of a JAX
    double-float ``DiaStreamDFDevice``: ``mask_b``, ``offsets``,
    ``vals_hi``, ``vals_lo`` and ``shape``; each coefficient is
    ``vals_hi + vals_lo`` summed in float64;
  * ``"dia"`` — a value-plane ``DiaDevice`` (K5, K5d) from a JAX
    ``DiaDevice``: ``data`` (K, num_rows; float32 or float64),
    ``offsets`` and ``shape``;
  * ``"dia_planes"`` — a ``DiaDevice`` from the value-plane form of a
    JAX ``DiaStreamDevice``: ``data_b`` ((nb, K, R, 128), float32 or
    bf16), unblocked to (K, num_rows) as the JAX package does
    (``ops/dia.py:172-174``; the entries past ``num_rows`` are the zero
    pad and are dropped), ``offsets`` and ``shape``;
  * ``"dia_df"`` — a float64 ``DiaDevice`` from the value-plane form of
    a JAX ``DiaStreamDFDevice``: ``data_hi`` and ``data_lo`` (blocked
    as ``data_b``), summed in float64, ``offsets`` and ``shape``;
  * ``"csr"`` — a merge plan from ``row_offsets``, ``col_indices``,
    ``values`` and ``shape`` (with float64 values, the host CSR a JAX
    double-float merge plan was built from);
  * ``"row_split"`` — a row-split plan (K4) from the same CSR arrays;
  * ``"ell"`` — a row-split plan rebuilt from a JAX ``DeviceEll``'s
    gather-job tiles: ``vals`` and ``local_cols`` (ntiles, J, 128),
    ``row_block`` (ntiles,), ``job_cblk`` (ntiles * J,) and ``shape``.
    Slot (t, j, lane) holds the entry at row ``row_block[t] * 128 +
    lane`` and column ``job_cblk[t * J + j] * 128 + local_cols[t, j,
    lane]``; entries are sorted by (row, column). A pad slot and an
    explicit zero both read 0 and are dropped alike, so the rebuilt CSR
    equals the original only for a matrix with no explicit zeros.

A double-float pair holds ``hi = f32(a)`` and ``lo = f32(a - hi)``, so
the float64 sum ``hi + lo`` of the two ``_df`` kinds is within 2^-48
relative of the original float64 value ``a``, not always equal to it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix, value_dtype
from tpusparse_torch.formats.dia import PLANE_DTYPES, DiaDevice
from tpusparse_torch.kernels.dia_stream import from_mask_words
from tpusparse_torch.kernels.ell_spmm import to_device_row_split
from tpusparse_torch.kernels.merge_spmv import to_device_merge

LANES = 128  # rows per row block and columns per column block of ELL
KINDS = ("dia_masked", "dia_masked_df", "dia", "dia_planes", "dia_df",
         "csr", "row_split", "ell")


def plan_from_arrays(kind: str, arrays: dict, device, dtype=None):
    if kind not in KINDS:
        raise ValueError(f"unknown plan kind {kind!r} ({', '.join(KINDS)})")
    n_rows, n_cols = (int(s) for s in arrays["shape"])
    if kind in ("dia", "dia_planes", "dia_df"):
        D = _dia_of_planes(kind, arrays, n_rows, n_cols, device)
        if dtype is not None:
            D.data = D.data.to(value_dtype(dtype))
        return D
    if dtype is None:
        dtype = torch.float64 if kind.endswith("_df") else torch.float32
    if kind in ("dia_masked", "dia_masked_df"):
        words = np.asarray(arrays["mask_b"]).reshape(-1)
        if np.any(words[n_rows:] != 0):
            raise ValueError("mask words past num_rows must be the zero pad")
        if kind == "dia_masked_df":
            vals = (np.asarray(arrays["vals_hi"], dtype=np.float64)
                    + np.asarray(arrays["vals_lo"], dtype=np.float64))
        else:
            vals = arrays["vals"]
        return from_mask_words(n_rows, n_cols, arrays["offsets"], vals,
                               words[:n_rows], device, dtype)
    if kind == "ell":
        csr = _csr_of_ell(arrays, n_rows, n_cols)
    else:
        csr = CsrMatrix(n_rows, n_cols, np.asarray(arrays["row_offsets"]),
                        np.asarray(arrays["col_indices"]),
                        np.asarray(arrays["values"]))
    if kind == "csr":
        return to_device_merge(csr, device, dtype)
    return to_device_row_split(csr, device, dtype)


def _dia_of_planes(kind, arrays, n_rows, n_cols, device) -> DiaDevice:
    """A ``DiaDevice`` from (K, n) planes or (nb, K, R, 128) blocks:
    float32, bf16 and float64 planes keep their type bit for bit; a
    double-float pair of blocks becomes float64 planes ``hi + lo``."""
    offsets = tuple(int(o) for o in arrays["offsets"])
    if kind == "dia":
        data = _planes_tensor(arrays["data"])
    else:
        if kind == "dia_df":
            blocks = (_planes_tensor(arrays["data_hi"]).double()
                      + _planes_tensor(arrays["data_lo"]).double())
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
    if data.dtype not in PLANE_DTYPES:
        raise TypeError(f"planes are float32, bf16 or float64, got "
                        f"{data.dtype}")
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
