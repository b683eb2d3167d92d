"""Hybrid DIA + remainder plan (port of ``tpusparse/ops/hybrid.py``).

``A = A_dia + A_rest`` elementwise, so ``y = A_dia x + A_rest x``: the
dense diagonals run on the masked DIA kernel (K1, or K7 for a row-major
float32 block) or, where they are not square and constant-coefficient,
on the value-plane kernel (K5); the scattered remainder on the merge
plan (K2 for SpMV, K3 for SpMM). A float64 plan runs the float64 twins
(K1d or K5d, then K2d or K3d), and both parts and their sum stay
float64: nothing passes through float32. ``ops/spmv.py`` runs the two
parts and adds them.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class HybridPlan:
    """DIA part + a plan for the remainder (None when the diagonals
    cover the whole matrix — then this is pure DIA)."""

    dia: Any             # DiaStreamDevice (K1), formats.dia.DiaDevice (K5)
                         # or kernels.dia_nmajor.DiaNMajorDevice (K7)
    rest: Any            # MergeDevice or None
    nnz: int             # real nonzeros (for flop accounting)
