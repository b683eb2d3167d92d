"""DIA SpMV / SpMM on value planes (port of ``tpusparse/ops/dia.py``).

For each stored diagonal ``off``: ``y[i] += data[k, i] * x[i + off]``,
in offset order, through kernel K5 (``kernels/dia_stream.py``) for
float32 and bf16 planes, in float32, and K5d for float64 planes, in
float64: x is cast to the planes' compute type, so a float64 plan never
computes in float32. The
operator may be rectangular (x of length num_cols); the JAX package's
``_pads`` zero padding of x is the guard K5 applies to its loads.

``xla_matvec_of`` is not ported: it exists only to bake plans into XLA
while-loops on the TPU, and the port's solvers call K5 directly.
"""

from __future__ import annotations

import torch

from tpusparse_torch.formats.dia import DiaDevice
from tpusparse_torch.kernels.dia_stream import (
    planes_value_dtype,
    spmm_dia_planes_t,
)


def spmm_dia_t(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    """Transposed-layout SpMM: XT (L, num_cols) -> A @ X as (L,
    num_rows), with no boundary transposes (the solvers' layout)."""
    return spmm_dia_planes_t(D, XT.to(planes_value_dtype(D)).contiguous())


def spmm_dia(D: DiaDevice, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y, X of shape (num_cols, L)."""
    Y_new = spmm_dia_t(D, X.T).T
    if beta == 0.0 or Y is None:
        return alpha * Y_new if alpha != 1.0 else Y_new
    return alpha * Y_new + beta * Y


def spmv_dia(D: DiaDevice, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y."""
    y_new = spmm_dia_t(D, x.reshape(1, -1))[0]
    if beta == 0.0 or y is None:
        return alpha * y_new if alpha != 1.0 else y_new
    return alpha * y_new + beta * y
