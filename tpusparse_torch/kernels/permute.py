"""Exact row permutation y = x[perm] — kernel K6 and its plain version.

Port of ``tpusparse/kernels/permute.py``. K6 (``csrc/permute.cu``)
replaces the Pallas kernel ``_permute_call`` (body ``_permute_kernel``).
The TPU kernel needs a host plan (``PermutePlan``: (8, 128) subtiles,
``SPAN`` source blocks each, ``SUBTILES_PER_STEP`` per grid step) because
the TPU has no fast element gather, and its ``PERMUTE_MAX_BYTES`` limit
sends callers back to XLA's gather. None of that is ported: K6 reads
``perm`` itself, so the "plan" is the validated int32 permutation on the
device (``build_permute_plan``).

K6 moves bits, so it is exact for every type it takes: float32, float64
and int32, as a vector (n,) or a row-major block (n, L). The JAX kernel
takes 4-byte vectors only (Mosaic has no 64-bit types); its callers
gather everything else with XLA.

The plain version is ``x.index_select(0, perm)``. It serves CPU tensors
only: a CUDA tensor launches K6 or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import trace

PERMUTE_DTYPES = (torch.float32, torch.float64, torch.int32)


def build_permute_plan(perm, device="cuda") -> torch.Tensor:
    """The permutation ``perm`` (host, gather convention: row i of the
    result is row ``perm[i]`` of the input) as an int32 tensor on
    ``device``. Raises ValueError for a ``perm`` that is not 1-D or has
    an entry outside [0, n): K6 does not check its indices. Bijectivity
    is not checked (the JAX package's builder does not either)."""
    p = np.asarray(perm)
    if p.ndim != 1:
        raise ValueError(f"perm must be 1-D, got shape {p.shape}")
    n = p.size
    if n and (p.min() < 0 or p.max() >= n):
        raise ValueError(f"perm entries must lie in [0, {n}); got range "
                         f"[{p.min()}, {p.max()}]")
    return torch.from_numpy(p.astype(np.int32)).to(device)


def permute_plain(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: ``x[perm]`` along the rows."""
    return x.index_select(0, perm)


def _check(perm: torch.Tensor, x: torch.Tensor) -> None:
    if perm.dtype != torch.int32 or perm.dim() != 1:
        raise TypeError("K6 needs a 1-D int32 permutation "
                        "(build_permute_plan)")
    if x.dim() not in (1, 2) or x.shape[0] != perm.shape[0]:
        raise ValueError(f"permute_apply: x has {x.shape[0] if x.dim() else 0}"
                         f" rows but the plan permutes {perm.shape[0]} "
                         f"(x of shape {tuple(x.shape)})")
    if x.dtype not in PERMUTE_DTYPES:
        raise TypeError(f"K6 takes float32, float64 or int32, got {x.dtype}")
    if perm.device != x.device:
        raise ValueError(f"x on {x.device}, perm on {perm.device}: same "
                         "device needed")


def _word_bytes(row_bytes: int, *tensors) -> int:
    """The widest word (16, 8 or 4 bytes) that divides a row and the
    alignment of every pointer."""
    for w in (16, 8, 4):
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 4


def _launch(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.shape[0]
    if y.numel() == 0:
        return y
    row_bytes = x.numel() // n * x.element_size()
    wb = _word_bytes(row_bytes, x, y)
    _build.launch("tps_permute", "K6", x.device,
                  perm.contiguous().data_ptr(), x.data_ptr(), y.data_ptr(),
                  n, row_bytes // wb, wb)
    return y


def permute_apply(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = x[perm]`` for x of shape (n,) or (n, L) and an int32 ``perm``
    of ``build_permute_plan``: K6 on a CUDA tensor, the plain version on
    a CPU tensor; any other device raises."""
    _check(perm, x)
    if x.device.type == "cuda":
        with trace.span("kernel.K6"):
            return _launch(perm, x)
    if x.device.type == "cpu":
        return permute_plain(perm, x)
    raise ValueError(f"no K6 path for device {x.device}")
