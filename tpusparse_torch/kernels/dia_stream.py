"""DIA stream — kernels K1 (masked) and K5 (value planes).

Port of ``tpusparse/kernels/dia_stream.py``. A constant-coefficient
diagonal operator (every diagonal holds one value wherever it is
populated, ``formats.dia.plane_constants``) compresses its K value
planes to one bit-mask word per row (bit k = plane k populated) plus K
scalars, and y = A x reads 4 B of operand per row. Any other diagonal
operator keeps its K value planes (``formats.dia.DiaDevice``), float32
or bf16.

K1 (``csrc/dia_masked.cu``) replaces the Pallas kernel
``tpusparse/kernels/dia_stream.py::_spmm_dia_stream_edge_mask``; K5
(``csrc/dia_planes.cu``) replaces ``_spmm_dia_stream_edge`` and its
MXU-rotation variant ``_spmm_dia_stream_edge_mxu``, which compute the
same y. The TPU layout's blocking ((nb, R, 128) blocks, edge-halo x
slabs, padded transposed state) has no counterpart: the mask is flat
(n,) words, the planes (K, n), and x is (L, num_cols), the JAX
package's transposed layout, unpadded. ``fits_stream``,
``choose_block_rows`` and the other block-geometry helpers go with it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tpusparse_torch.formats.dia import DiaDevice, plane_constants
from tpusparse_torch.kernels import _build

# Masked DIA packs one validity bit per plane into a 32-bit word per row.
MASK_MAX_PLANES = 32
# K5 takes its offsets by value in kernel parameters (formats.dia.MAX_DIAGS).
PLANES_MAX = 64

# K1 launches since the count was last reset (plain runs not counted).
LAUNCHES = 0
# K5 launches, counted apart from K1's.
PLANES_LAUNCHES = 0


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
    ``offsets``: static tuple of K ints; ``vals``: (K,) float32 on the
    device (read by the plain version); ``vals_host``: the same K
    float32 values as Python floats, passed by value to K1."""

    num_rows: int
    num_cols: int
    offsets: tuple
    vals: torch.Tensor
    mask: torch.Tensor
    vals_host: tuple


def from_mask_words(num_rows: int, num_cols: int, offsets, vals, words,
                    device) -> DiaStreamDevice:
    """Build the operand from host mask words (uint32 or int32 bits)."""
    offsets = tuple(int(o) for o in offsets)
    vals32 = np.asarray(vals, dtype=np.float32).reshape(-1)
    words = np.ascontiguousarray(np.asarray(words).reshape(-1))
    if words.dtype.itemsize != 4 or words.dtype.kind not in "iu":
        raise TypeError(
            f"mask words must be 32-bit integers, got {words.dtype}")
    if num_rows != num_cols:
        raise ValueError("the masked DIA operand is square only")
    if words.shape[0] != num_rows or len(offsets) != vals32.shape[0]:
        raise ValueError("mask words / offsets / vals disagree in size")
    if len(offsets) > MASK_MAX_PLANES:
        raise ValueError(f"{len(offsets)} planes exceed {MASK_MAX_PLANES}")
    return DiaStreamDevice(
        num_rows, num_cols, offsets,
        torch.from_numpy(vals32.copy()).to(device),
        torch.from_numpy(words.view(np.int32).copy()).to(device),
        tuple(float(v) for v in vals32),
    )


def to_device_dia_stream(dia_host, device) -> DiaStreamDevice:
    """Ship a host DIA plan in masked form; raises if any plane is not
    a constant coefficient."""
    vals64, ok = _maskable(dia_host)
    if not ok:
        raise ValueError(
            "masked stream plan requires every diagonal to be a constant "
            "coefficient (formats.dia.plane_constants)")
    return from_mask_words(dia_host.num_rows, dia_host.num_cols,
                           dia_host.offsets, vals64, mask_words(dia_host),
                           device)


def spmm_dia_masked_plain(D: DiaStreamDevice,
                          XT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: (L, n) -> (L, n), the same products
    and sums in the same order (offset order, out-of-range x reads 0)."""
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
    if XT.dtype != torch.float32 or D.vals.dtype != torch.float32:
        raise TypeError(f"K1 is float32 only, got {XT.dtype}")
    if D.mask.dtype != torch.int32 or D.mask.shape != (D.num_rows,):
        raise TypeError("mask must be (num_rows,) int32")
    if not (XT.is_contiguous() and D.mask.is_contiguous()):
        raise ValueError("K1 needs contiguous XT and mask")
    if XT.device != D.mask.device or D.vals.device != D.mask.device:
        raise ValueError(
            f"XT on {XT.device}, operand on {D.mask.device}: same device "
            "needed")


def _launch(D: DiaStreamDevice, XT: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    L, n = XT.shape
    K = len(D.offsets)
    Y = torch.empty((L, n), dtype=torch.float32, device=XT.device)
    offs = (ctypes.c_int * max(K, 1))(*D.offsets)
    vals = (ctypes.c_float * max(K, 1))(*D.vals_host)
    lib = _build.library()
    with torch.cuda.device(XT.device):
        stream = torch.cuda.current_stream(XT.device).cuda_stream
        rc = lib.tps_dia_masked(D.mask.data_ptr(), XT.data_ptr(),
                                Y.data_ptr(), n, L, K,
                                ctypes.addressof(offs),
                                ctypes.addressof(vals), stream)
    _build.check(rc, "tps_dia_masked")
    LAUNCHES += 1
    return Y


def spmm_dia_stream_t(D: DiaStreamDevice, XT: torch.Tensor) -> torch.Tensor:
    """Transposed-layout product: XT (L, num_cols) float32 -> A @ X as
    (L, num_rows). K1 on a CUDA tensor, the plain version on a CPU
    tensor; any other device raises."""
    _check(D, XT)
    if XT.device.type == "cuda":
        return _launch(D, XT)
    if XT.device.type == "cpu":
        return spmm_dia_masked_plain(D, XT)
    raise ValueError(f"no K1 path for device {XT.device}")


def spmm_dia_planes_plain(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: (L, num_cols) -> (L, num_rows), the
    same products and sums in the same order (offset order, planes
    upcast to float32, columns outside [0, num_cols) read 0)."""
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


def _check_planes(D: DiaDevice, XT: torch.Tensor) -> None:
    K = len(D.offsets)
    if XT.dim() != 2 or XT.shape[1] != D.num_cols:
        raise ValueError(
            f"XT must be (L, {D.num_cols}), got {tuple(XT.shape)}")
    if XT.dtype != torch.float32:
        raise TypeError(f"K5 takes float32 XT, got {XT.dtype}")
    if D.data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 planes are float32 or bf16, got {D.data.dtype}")
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
    global PLANES_LAUNCHES
    L, K, n = XT.shape[0], len(D.offsets), D.num_rows
    if n == 0 or L == 0 or K == 0:
        return torch.zeros((L, n), dtype=torch.float32, device=XT.device)
    Y = torch.empty((L, n), dtype=torch.float32, device=XT.device)
    offs = (ctypes.c_longlong * K)(*D.offsets)
    lib = _build.library()
    with torch.cuda.device(XT.device):
        stream = torch.cuda.current_stream(XT.device).cuda_stream
        rc = lib.tps_dia_planes(D.data.data_ptr(),
                                int(D.data.dtype == torch.bfloat16),
                                XT.data_ptr(), Y.data_ptr(), n, D.num_cols,
                                L, K, ctypes.addressof(offs), stream)
    _build.check(rc, "tps_dia_planes")
    PLANES_LAUNCHES += 1
    return Y


def spmm_dia_planes_t(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    """Transposed-layout product on value planes: XT (L, num_cols)
    float32 -> A @ X as (L, num_rows). K5 on a CUDA tensor, the plain
    version on a CPU tensor; any other device raises."""
    _check_planes(D, XT)
    if XT.device.type == "cuda":
        return _launch_planes(D, XT)
    if XT.device.type == "cpu":
        return spmm_dia_planes_plain(D, XT)
    raise ValueError(f"no K5 path for device {XT.device}")


def spmv_dia_stream(D: DiaStreamDevice, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y at L = 1."""
    y_new = spmm_dia_stream_t(D, x.to(torch.float32).reshape(1, -1))[0]
    if beta == 0.0 or y is None:
        return alpha * y_new if alpha != 1.0 else y_new
    return alpha * y_new + beta * y


def spmm_dia_stream(D: DiaStreamDevice, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y for X (num_cols, L): the transposed
    product on X.T, transposed back (the (n, L) layout at the public
    function, as in the JAX package)."""
    Y_new = spmm_dia_stream_t(D, X.to(torch.float32).T.contiguous()).T
    if beta == 0.0 or Y is None:
        return alpha * Y_new if alpha != 1.0 else Y_new
    return alpha * Y_new + beta * Y
