"""Single-vector BLAS-1 for CG (port of ``tpusparse/ops/blas.py``).

Plain tensor expressions, as in the JAX package. The dot is an
elementwise product and PyTorch's own sum reduction (not ``torch.dot``,
which goes to cuBLAS on a CUDA tensor). The multi-RHS forms come with
ROADMAP A8; the JAX package's compensated float64 sum (``df_sum``)
works around the TPU's emulated float64 and has no counterpart.
"""

from __future__ import annotations

import torch


def dot_single(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parity: DotSingle. A 0-d tensor on the operands' device."""
    return torch.sum(a * b)


def axpy_single(y: torch.Tensor, alpha, x: torch.Tensor) -> torch.Tensor:
    """Parity: AxpySingle: y + alpha * x."""
    return y + alpha * x


def update_p_single(r: torch.Tensor, beta, p: torch.Tensor) -> torch.Tensor:
    """Parity: UpdatePSingle: r + beta * p."""
    return r + beta * p
