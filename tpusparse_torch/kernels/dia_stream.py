"""DIA stream — kernels K1 (masked) and K5 (value planes), and their
float64 twins K1d and K5d.

Port of ``tpusparse/kernels/dia_stream.py``. A constant-coefficient
diagonal operator (every diagonal holds one value wherever it is
populated, ``formats.dia.plane_constants``) compresses its K value
planes to one bit-mask word per row (bit k = plane k populated) plus K
scalars, and y = A x reads 4 B of operand per row. Any other diagonal
operator keeps its K value planes (``formats.dia.DiaDevice``), float32,
bf16 or float64.

K1 (``csrc/dia_masked.cu``) replaces the Pallas kernel
``tpusparse/kernels/dia_stream.py::_spmm_dia_stream_edge_mask``; K5
(``csrc/dia_planes.cu``) replaces ``_spmm_dia_stream_edge`` and its
MXU-rotation variant ``_spmm_dia_stream_edge_mxu``, which compute the
same y. K1d and K5d are the same CUDA templates at IEEE float64; they
replace the double-float (two-f32) kernels
``_spmm_dia_stream_df_edge_mask`` and ``_spmm_dia_stream_df_edge``, whose
hi/lo split of planes, coefficients, x and y has no counterpart. A
kernel runs in its operand's type: ``spmv_dia_stream`` and
``spmm_dia_stream`` cast x to it, and a kernel-level call with x of
another type raises TypeError. The TPU layout's blocking ((nb, R, 128)
blocks, edge-halo x slabs, padded transposed state) has no
counterpart: the mask is flat (n,) words, the planes (K, n), and x is
(L, num_cols), the JAX package's transposed layout, unpadded.
``fits_stream``, ``choose_block_rows`` and the other block-geometry
helpers go with it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tpusparse_torch.formats.csr import NUMPY_OF, VALUE_DTYPES, value_dtype
from tpusparse_torch.formats.dia import (
    PLANE_DTYPES,
    DiaDevice,
    plane_constants,
)
from tpusparse_torch.kernels import _build

# Masked DIA packs one validity bit per plane into a 32-bit word per row.
MASK_MAX_PLANES = 32
# K5 takes its offsets by value in kernel parameters (formats.dia.MAX_DIAGS).
PLANES_MAX = 64

# K1 launches since the count was last reset (plain runs not counted).
LAUNCHES = 0
# K5 launches, counted apart from K1's.
PLANES_LAUNCHES = 0
# K1d and K5d (float64) launches, counted apart from their float32 twins'.
LAUNCHES_F64 = 0
PLANES_LAUNCHES_F64 = 0

# ctypes scalar of K1's host coefficients, by operand type.
_C_VALS = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def mask_words(dia_host) -> np.ndarray:
    """(n,) uint32 validity words of a host DIA plan: bit k = plane k
    populated at that row — the JAX package's bit layout."""
    K = dia_host.offsets.shape[0]
    if K > MASK_MAX_PLANES:
        raise ValueError(f"{K} planes exceed the {MASK_MAX_PLANES}-bit mask")
    w = np.zeros(dia_host.num_rows, dtype=np.uint32)
    for k in range(K):
        w |= (dia_host.data[k] != 0).astype(np.uint32) << np.uint32(k)
    return w


def _maskable(dia_host) -> tuple:
    """(vals_f64, ok): masked-compression eligibility of a host plan."""
    if len(dia_host.offsets) > MASK_MAX_PLANES:
        return None, False
    vals, ok = plane_constants(dia_host.data)
    return vals, bool(ok.all())


@dataclasses.dataclass
class DiaStreamDevice:
    """Masked DIA operand on a device.

    ``mask``: (num_rows,) int32 words (the uint32 bits viewed as int32);
    ``offsets``: static tuple of K ints; ``vals``: (K,) float32 (K1) or
    float64 (K1d) on the device (read by the plain version);
    ``vals_host``: the same K values as Python floats, passed by value
    to the kernel."""

    num_rows: int
    num_cols: int
    offsets: tuple
    vals: torch.Tensor
    mask: torch.Tensor
    vals_host: tuple


def from_mask_words(num_rows: int, num_cols: int, offsets, vals, words,
                    device, dtype=torch.float32) -> DiaStreamDevice:
    """Build the operand from host mask words (uint32 or int32 bits),
    with coefficients ``vals`` in ``dtype`` (float32 rounds them,
    float64 keeps them)."""
    offsets = tuple(int(o) for o in offsets)
    dtype = value_dtype(dtype)
    vals = np.asarray(vals, dtype=NUMPY_OF[dtype]).reshape(-1)
    words = np.ascontiguousarray(np.asarray(words).reshape(-1))
    if words.dtype.itemsize != 4 or words.dtype.kind not in "iu":
        raise TypeError(
            f"mask words must be 32-bit integers, got {words.dtype}")
    if num_rows != num_cols:
        raise ValueError("the masked DIA operand is square only")
    if words.shape[0] != num_rows or len(offsets) != vals.shape[0]:
        raise ValueError("mask words / offsets / vals disagree in size")
    if len(offsets) > MASK_MAX_PLANES:
        raise ValueError(f"{len(offsets)} planes exceed {MASK_MAX_PLANES}")
    return DiaStreamDevice(
        num_rows, num_cols, offsets,
        torch.from_numpy(vals.copy()).to(device),
        torch.from_numpy(words.view(np.int32).copy()).to(device),
        tuple(float(v) for v in vals),
    )


def to_device_dia_stream(dia_host, device,
                         dtype=torch.float32) -> DiaStreamDevice:
    """Ship a host DIA plan in masked form, coefficients in ``dtype``;
    raises if any plane is not a constant coefficient."""
    vals64, ok = _maskable(dia_host)
    if not ok:
        raise ValueError(
            "masked stream plan requires every diagonal to be a constant "
            "coefficient (formats.dia.plane_constants)")
    return from_mask_words(dia_host.num_rows, dia_host.num_cols,
                           dia_host.offsets, vals64, mask_words(dia_host),
                           device, dtype)


def spmm_dia_masked_plain(D: DiaStreamDevice,
                          XT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 and K1d: (L, n) -> (L, n), the same
    products and sums in the same order (offset order, out-of-range x
    reads 0), in XT's dtype."""
    L, n = XT.shape
    E = max((abs(o) for o in D.offsets), default=0)
    xp = torch.zeros((L, n + 2 * E), dtype=XT.dtype, device=XT.device)
    xp[:, E:E + n] = XT
    acc = torch.zeros((L, n), dtype=XT.dtype, device=XT.device)
    zero = torch.zeros((), dtype=XT.dtype, device=XT.device)
    for k, off in enumerate(D.offsets):
        coef = torch.where(((D.mask >> k) & 1) != 0, D.vals[k], zero)
        acc = acc + coef * xp[:, E + off:E + off + n]
    return acc


def _check(D: DiaStreamDevice, XT: torch.Tensor) -> None:
    if XT.dim() != 2 or XT.shape[1] != D.num_cols:
        raise ValueError(
            f"XT must be (L, {D.num_cols}), got {tuple(XT.shape)}")
    if D.vals.dtype not in VALUE_DTYPES or XT.dtype != D.vals.dtype:
        raise TypeError(f"K1 takes XT in its operand's type "
                        f"({D.vals.dtype}), got {XT.dtype}")
    if D.mask.dtype != torch.int32 or D.mask.shape != (D.num_rows,):
        raise TypeError("mask must be (num_rows,) int32")
    if not (XT.is_contiguous() and D.mask.is_contiguous()):
        raise ValueError("K1 needs contiguous XT and mask")
    if XT.device != D.mask.device or D.vals.device != D.mask.device:
        raise ValueError(
            f"XT on {XT.device}, operand on {D.mask.device}: same device "
            "needed")


def _launch(D: DiaStreamDevice, XT: torch.Tensor) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F64
    L, n = XT.shape
    K = len(D.offsets)
    f64 = XT.dtype == torch.float64
    Y = torch.empty((L, n), dtype=XT.dtype, device=XT.device)
    offs = (ctypes.c_int * max(K, 1))(*D.offsets)
    vals = (_C_VALS[XT.dtype] * max(K, 1))(*D.vals_host)
    lib = _build.library()
    name = "tps_dia_masked_f64" if f64 else "tps_dia_masked"
    with torch.cuda.device(XT.device):
        stream = torch.cuda.current_stream(XT.device).cuda_stream
        rc = getattr(lib, name)(D.mask.data_ptr(), XT.data_ptr(),
                                Y.data_ptr(), n, L, K,
                                ctypes.addressof(offs),
                                ctypes.addressof(vals), stream)
    _build.check(rc, name)
    if f64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return Y


def spmm_dia_stream_t(D: DiaStreamDevice, XT: torch.Tensor) -> torch.Tensor:
    """Transposed-layout product: XT (L, num_cols) in the operand's type
    -> A @ X as (L, num_rows). K1 (float32) or K1d (float64) on a CUDA
    tensor, the plain version on a CPU tensor; any other device
    raises."""
    _check(D, XT)
    if XT.device.type == "cuda":
        return _launch(D, XT)
    if XT.device.type == "cpu":
        return spmm_dia_masked_plain(D, XT)
    raise ValueError(f"no K1 path for device {XT.device}")


def spmm_dia_planes_plain(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 and K5d: (L, num_cols) -> (L,
    num_rows), the same products and sums in the same order (offset
    order, planes upcast to XT's dtype, columns outside [0, num_cols)
    read 0)."""
    L = XT.shape[0]
    n = D.num_rows
    lo = max(0, -min(D.offsets, default=0))
    hi = max(0, max(D.offsets, default=0) + n - D.num_cols)
    xp = torch.zeros((L, lo + D.num_cols + hi), dtype=XT.dtype,
                     device=XT.device)
    xp[:, lo:lo + D.num_cols] = XT
    acc = torch.zeros((L, n), dtype=XT.dtype, device=XT.device)
    for k, off in enumerate(D.offsets):
        acc = acc + D.data[k].to(XT.dtype) * xp[:, lo + off:lo + off + n]
    return acc


def planes_value_dtype(D: DiaDevice) -> torch.dtype:
    """The type K5 (K5d) computes in for ``D``'s planes: float32 for
    float32 and bf16 planes, float64 for float64 planes."""
    return torch.float64 if D.data.dtype == torch.float64 else torch.float32


def _check_planes(D: DiaDevice, XT: torch.Tensor) -> None:
    K = len(D.offsets)
    if XT.dim() != 2 or XT.shape[1] != D.num_cols:
        raise ValueError(
            f"XT must be (L, {D.num_cols}), got {tuple(XT.shape)}")
    if D.data.dtype not in PLANE_DTYPES:
        raise TypeError(f"K5 planes are float32, bf16 or float64, got "
                        f"{D.data.dtype}")
    if XT.dtype != planes_value_dtype(D):
        raise TypeError(f"K5 takes {planes_value_dtype(D)} XT for "
                        f"{D.data.dtype} planes, got {XT.dtype}")
    if D.data.shape != (K, D.num_rows):
        raise ValueError(f"planes must be ({K}, {D.num_rows}), got "
                         f"{tuple(D.data.shape)}")
    if K > PLANES_MAX:
        raise ValueError(f"{K} planes exceed K5's {PLANES_MAX}")
    if not (XT.is_contiguous() and D.data.is_contiguous()):
        raise ValueError("K5 needs contiguous XT and planes")
    if XT.device != D.data.device:
        raise ValueError(
            f"XT on {XT.device}, operand on {D.data.device}: same device "
            "needed")


def _launch_planes(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    global PLANES_LAUNCHES, PLANES_LAUNCHES_F64
    L, K, n = XT.shape[0], len(D.offsets), D.num_rows
    if n == 0 or L == 0 or K == 0:
        return torch.zeros((L, n), dtype=XT.dtype, device=XT.device)
    Y = torch.empty((L, n), dtype=XT.dtype, device=XT.device)
    offs = (ctypes.c_longlong * K)(*D.offsets)
    lib = _build.library()
    f64 = XT.dtype == torch.float64
    with torch.cuda.device(XT.device):
        stream = torch.cuda.current_stream(XT.device).cuda_stream
        args = (XT.data_ptr(), Y.data_ptr(), n, D.num_cols, L, K,
                ctypes.addressof(offs), stream)
        if f64:
            rc = lib.tps_dia_planes_f64(D.data.data_ptr(), *args)
        else:
            rc = lib.tps_dia_planes(D.data.data_ptr(),
                                    int(D.data.dtype == torch.bfloat16),
                                    *args)
    _build.check(rc, "tps_dia_planes_f64" if f64 else "tps_dia_planes")
    if f64:
        PLANES_LAUNCHES_F64 += 1
    else:
        PLANES_LAUNCHES += 1
    return Y


def spmm_dia_planes_t(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    """Transposed-layout product on value planes: XT (L, num_cols) in
    the planes' compute type (``planes_value_dtype``) -> A @ X as (L,
    num_rows). K5 (float32 or bf16 planes) or K5d (float64 planes) on a
    CUDA tensor, the plain version on a CPU tensor; any other device
    raises."""
    _check_planes(D, XT)
    if XT.device.type == "cuda":
        return _launch_planes(D, XT)
    if XT.device.type == "cpu":
        return spmm_dia_planes_plain(D, XT)
    raise ValueError(f"no K5 path for device {XT.device}")


def spmv_dia_stream(D: DiaStreamDevice, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y at L = 1."""
    y_new = spmm_dia_stream_t(D, x.to(D.vals.dtype).reshape(1, -1))[0]
    if beta == 0.0 or y is None:
        return alpha * y_new if alpha != 1.0 else y_new
    return alpha * y_new + beta * y


def spmm_dia_stream(D: DiaStreamDevice, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y for X (num_cols, L): the transposed
    product on X.T, transposed back (the (n, L) layout at the public
    function, as in the JAX package)."""
    Y_new = spmm_dia_stream_t(D, X.to(D.vals.dtype).T.contiguous()).T
    if beta == 0.0 or Y is None:
        return alpha * Y_new if alpha != 1.0 else Y_new
    return alpha * Y_new + beta * Y
