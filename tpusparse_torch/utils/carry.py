"""Carrying a JAX plan's state across to the port.

``plan_from_arrays(kind, arrays, device)`` turns the arrays of a
``tpusparse`` plan, taken out as numpy (``np.asarray``), into the
port's plan, so that both packages can run on the same operand:

  * ``"dia_masked"`` — a ``DiaStreamDevice`` in masked form:
    ``mask_b`` ((nb, R, 128) int32 blocks; the words past ``num_rows``
    are the zero pad and are dropped), ``offsets``, ``vals`` and
    ``shape``;
  * ``"csr"`` — a merge plan from ``row_offsets``, ``col_indices``,
    ``values`` and ``shape``.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.kernels.dia_stream import from_mask_words
from tpusparse_torch.kernels.merge_spmv import to_device_merge


def plan_from_arrays(kind: str, arrays: dict, device):
    n_rows, n_cols = (int(s) for s in arrays["shape"])
    if kind == "dia_masked":
        words = np.asarray(arrays["mask_b"]).reshape(-1)
        if np.any(words[n_rows:] != 0):
            raise ValueError("mask words past num_rows must be the zero pad")
        return from_mask_words(n_rows, n_cols, arrays["offsets"],
                               arrays["vals"], words[:n_rows], device)
    if kind == "csr":
        csr = CsrMatrix(n_rows, n_cols, np.asarray(arrays["row_offsets"]),
                        np.asarray(arrays["col_indices"]),
                        np.asarray(arrays["values"]))
        return to_device_merge(csr, device)
    raise ValueError(f"unknown plan kind {kind!r} (dia_masked, csr)")
