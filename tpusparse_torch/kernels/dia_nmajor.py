"""N-major masked DIA SpMM — kernel K7.

Port of ``tpusparse/kernels/dia_nmajor.py``. A square
constant-coefficient band of at most 32 diagonals (the masked operand of
K1, ``dia_stream.DiaStreamDevice``) multiplies a block of right-hand
sides kept in its natural row-major (n, L) layout: Y (n, L) = A X (n, L),
with no transposes around the kernel. K7 takes the band itself
(``nmajor_matmat``), so two routes reach it with one operand: the
explicit n-major plan (``plan_matrix(..., 'nmajor', L=L)``, a
``DiaNMajorDevice`` around the band), and ``spmm`` on AUTO's masked band
with a row-major float32 X of 2 to 128 columns (``ops/spmv.py`` picks the
route).

K7 (``csrc/dia_nmajor.cu``) replaces the Pallas kernel ``_spmm_nmajor``
(body ``_nmajor_kernel``). It reads K1's per-row mask words and its K
by-value coefficients and keeps K1's contract (out-of-range rows read 0,
in-range loads are multiplied even by a zero coefficient, products and
sums round separately in offset order), so it equals its plain version
and K1 on X.T, transposed back, bit for bit. The TPU layout goes: the
packed per-sublane mask words, the guard blocks, the flat (T, 128) view
and its lane padding, ``plan_geometry``, ``S_TARGET``, ``_vmem_need``,
``fold_lanes`` and ``tile_lanes``. The plan keeps the JAX package's
padded lane count (``L``, the next of 4, 8, ..., 128 at or above the
requested L) as the most columns it serves; K7 runs on the caller's
columns, unpadded.

K7's decomposition (``csrc/dia_nmajor.cu``): a thread owns one lane
group of V values (``k7_lane_group``: 4, 2 or 1, from L and the
pointers' alignment) in ``K7_ROWS`` rows; the L / V threads of a row are
neighbours, a sub-block's ``K7_THREADS`` / (L / V) row slots hold
consecutive rows, and a thread's rows are its slot and the slots one,
two, ... sub-block widths further on; a CTA walks ``K7_SUB_BLOCKS``
sub-blocks in order (``k7_geometry``). The constants mirror the source's
and are checked against the library before each launch.

The kernel is float32 only, as the JAX one is. The plain version serves
CPU tensors only: a CUDA tensor launches K7 or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.dia_stream import (
    DiaStreamDevice,
    _maskable,
    to_device_dia_stream,
)

# The JAX package's padded lane counts (divisors of 128, floored at 4);
# the last is the most columns K7 takes.
LANE_COUNTS = (4, 8, 16, 32, 64, 128)

# K7's geometry, mirrored from csrc/dia_nmajor.cu (kThreads, kRows,
# kSubBlocks, kVectorBytes) and checked against the library at every
# launch: threads a CTA, rows a thread, sub-blocks a CTA walks, bytes of
# the widest lane group.
K7_THREADS = 256
K7_ROWS = 4
K7_SUB_BLOCKS = 1
K7_VECTOR_BYTES = 16


def k7_lane_group(L: int, *tensors) -> int:
    """V, the float32 values of a thread's lane group: the widest of
    4, 2 and 1 that divides L and whose 4 V bytes align every tensor's
    data pointer."""
    for v in (K7_VECTOR_BYTES // 4, 2, 1):
        if L % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def k7_geometry(L: int, V: int) -> dict:
    """K7's decomposition of an (n, L) block in lane groups of V values:
    ``groups`` threads a row, ``runs`` row slots a sub-block of ``rows``
    times as many rows (a thread's rows lie ``runs`` apart),
    ``sub_blocks`` sub-blocks (``cta_rows`` rows) a CTA of ``threads``
    threads."""
    groups = L // V
    runs = K7_THREADS // groups
    return {"threads": K7_THREADS, "rows": K7_ROWS, "groups": groups,
            "runs": runs, "sub_blocks": K7_SUB_BLOCKS,
            "cta_rows": K7_SUB_BLOCKS * runs * K7_ROWS}


def padded_lane_count(L: int) -> int:
    """The smallest of ``LANE_COUNTS`` at or above L (the JAX package's
    ``_next_lane_count``); raises ValueError past 128."""
    for p in LANE_COUNTS:
        if p >= L:
            return p
    raise ValueError(f"n-major plans support L <= 128, got {L}")


@dataclasses.dataclass
class DiaNMajorDevice:
    """N-major masked DIA operand: the masked band (K1's operand: mask
    words, offsets, float32 coefficients) and ``L``, the most right-hand
    sides the plan serves (the JAX package's padded lane count)."""

    band: DiaStreamDevice
    L: int

    @property
    def num_rows(self) -> int:
        return self.band.num_rows

    @property
    def num_cols(self) -> int:
        return self.band.num_cols

    @property
    def offsets(self) -> tuple:
        return self.band.offsets


def to_device_dia_nmajor(dia_host, L: int, device) -> DiaNMajorDevice:
    """Ship a constant-coefficient host DIA plan for up to L right-hand
    sides (2 <= L <= 128, recorded padded as the JAX package pads it).
    Raises ValueError for another L, a non-square or a non-maskable
    band."""
    if L < 2 or L > LANE_COUNTS[-1]:
        raise ValueError(f"n-major plans need 2 <= L <= 128, got L={L}")
    if dia_host.num_rows != dia_host.num_cols:
        raise ValueError("n-major DIA plans require a square matrix")
    if not _maskable(dia_host)[1]:
        raise ValueError(
            "n-major plan requires every diagonal to be a constant "
            "coefficient (formats.dia.plane_constants)")
    return DiaNMajorDevice(to_device_dia_stream(dia_host, device),
                           padded_lane_count(L))


def spmm_nmajor_plain(B: DiaStreamDevice, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 on the band ``B``: (n, L) -> (n, L),
    the same products and sums in the same order as K7 (and as K1's
    plain version on X.T)."""
    n, L = X.shape
    E = max((abs(o) for o in B.offsets), default=0)
    xp = torch.zeros((n + 2 * E, L), dtype=X.dtype, device=X.device)
    xp[E:E + n] = X
    acc = torch.zeros((n, L), dtype=X.dtype, device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for k, off in enumerate(B.offsets):
        coef = torch.where(((B.mask >> k) & 1) != 0, B.vals[k], zero)
        acc = acc + coef[:, None] * xp[E + off:E + off + n]
    return acc


def _check(B: DiaStreamDevice, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.shape[0] != B.num_cols:
        raise ValueError(
            f"X must be ({B.num_cols}, L), got {tuple(X.shape)}")
    if X.shape[1] > LANE_COUNTS[-1]:
        raise ValueError(f"K7 takes L <= {LANE_COUNTS[-1]} columns, got "
                         f"{X.shape[1]}")
    if X.dtype != torch.float32 or B.vals.dtype != torch.float32:
        raise TypeError(f"K7 is float32 only (operand {B.vals.dtype}, X "
                        f"{X.dtype})")
    if B.mask.dtype != torch.int32 or B.mask.shape != (B.num_rows,):
        raise TypeError("mask must be (num_rows,) int32")
    if not (X.is_contiguous() and B.mask.is_contiguous()):
        raise ValueError("K7 needs contiguous X and mask")
    if X.device != B.mask.device or B.vals.device != B.mask.device:
        raise ValueError(
            f"X on {X.device}, operand on {B.mask.device}: same device "
            "needed")


def _launch(B: DiaStreamDevice, X: torch.Tensor) -> torch.Tensor:
    n, L = X.shape
    _build.geometry("tps_dia_nmajor_geometry", (),
                    (K7_THREADS, K7_ROWS, K7_SUB_BLOCKS, K7_VECTOR_BYTES),
                    "K7", "dia_nmajor.py")
    Y = torch.empty((n, L), dtype=X.dtype, device=X.device)
    _build.launch("tps_dia_nmajor", "K7", X.device, B.mask.data_ptr(),
                  X.data_ptr(), Y.data_ptr(), n, L, k7_lane_group(L, X, Y),
                  len(B.offsets), ctypes.addressof(B.c_offsets),
                  ctypes.addressof(B.c_vals))
    return Y


def nmajor_matmat(B: DiaStreamDevice, X: torch.Tensor) -> torch.Tensor:
    """A @ X for the float32 masked band ``B`` and X (num_cols, L)
    float32, row-major, L <= 128: K7 on a CUDA tensor, the plain version
    on a CPU tensor; any other device raises."""
    _check(B, X)
    if X.device.type == "cuda":
        return _launch(B, X)
    if X.device.type == "cpu":
        return spmm_nmajor_plain(B, X)
    raise ValueError(f"no K7 path for device {X.device}")
