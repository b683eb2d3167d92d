"""Hybrid DIA + remainder plan (port of ``tpusparse/ops/hybrid.py``).

``A = A_dia + A_rest`` elementwise, so ``y = A_dia x + A_rest x``: the
dense diagonals run on the masked DIA kernel (K1) or, where they are not
square and constant-coefficient, on the value-plane kernel (K5); the
scattered remainder on the merge plan (K2 for SpMV, K3 for SpMM). A
float64 plan runs the float64 twins (K1d or K5d, then K2d or K3d), and
both parts and their sum stay float64: nothing passes through float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class HybridPlan:
    """DIA part + a plan for the remainder (None when the diagonals
    cover the whole matrix — then this is pure DIA)."""

    dia: Any             # DiaStreamDevice (K1) or formats.dia.DiaDevice (K5)
    rest: Any            # MergeDevice or None
    nnz: int             # real nonzeros (for flop accounting)


def spmv_hybrid(H: HybridPlan, x, alpha=1.0, beta=0.0, y=None):
    from tpusparse_torch.ops.spmv import spmv

    y_new = spmv(H.dia, x)
    if H.rest is not None:
        y_new = spmv(H.rest, x, beta=1.0, y=y_new)
    if beta == 0.0 or y is None:
        return alpha * y_new if alpha != 1.0 else y_new
    return alpha * y_new + beta * y


def spmm_hybrid(H: HybridPlan, X, alpha=1.0, beta=0.0, Y=None):
    """The same split for X (num_cols, L); K1 and K5 run on X.T, so the
    DIA part transposes at its boundary."""
    from tpusparse_torch.ops.spmv import spmm

    Y_new = spmm(H.dia, X)
    if H.rest is not None:
        Y_new = spmm(H.rest, X, beta=1.0, Y=Y_new)
    if beta == 0.0 or Y is None:
        return alpha * Y_new if alpha != 1.0 else Y_new
    return alpha * Y_new + beta * Y
