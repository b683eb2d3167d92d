"""BLAS-1 for CG, single and multi-RHS (port of
``tpusparse/ops/blas.py``).

Plain tensor expressions, as in the JAX package. The dot is an
elementwise product and PyTorch's own sum reduction (not ``torch.dot``,
which goes to cuBLAS on a CUDA tensor). The multi-RHS forms take (n, L)
blocks and per-lane (L,) scalars; their ``_t`` forms take (L, n) blocks,
the DIA kernels' own layout, in which the blocked solvers keep their
state on a plan that is all diagonals. The JAX package's compensated float64
sum (``df_sum``) works around the TPU's emulated float64 and has no
counterpart.
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


def dot_multiple(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parity: dot_multiple. Per-lane dots of (n, L) blocks -> (L,)."""
    return torch.sum(a * b, dim=0)


def axpy_multiple(y: torch.Tensor, alpha: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Parity: axpy_multiple: y + alpha[None, :] * x, alpha (L,)."""
    return y + alpha[None, :] * x


def update_p_multiple(r: torch.Tensor, beta: torch.Tensor,
                      p: torch.Tensor) -> torch.Tensor:
    """Parity: update_p_multiple: r + beta[None, :] * p, beta (L,)."""
    return r + beta[None, :] * p


def dot_multiple_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dots of (L, n) blocks -> (L,)."""
    return torch.sum(a * b, dim=1)


def axpy_multiple_t(y: torch.Tensor, alpha: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """y + alpha[:, None] * x for (L, n) blocks, alpha (L,)."""
    return y + alpha[:, None] * x


def update_p_multiple_t(r: torch.Tensor, beta: torch.Tensor,
                        p: torch.Tensor) -> torch.Tensor:
    """r + beta[:, None] * p for (L, n) blocks, beta (L,)."""
    return r + beta[:, None] * p
