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
kernel runs in its operand's type: the dispatch layer (``ops/spmv.py``)
casts x to it, and a kernel-level call with x of another type raises
TypeError. The TPU layout's blocking ((nb, R, 128) blocks, edge-halo x
slabs, padded transposed state) has no counterpart: the mask is flat
(n,) words, the planes (K, n), and x is (L, num_cols), the JAX
package's transposed layout, unpadded.
``fits_stream``, ``choose_block_rows`` and the other block-geometry
helpers go with it.

A K1 thread owns R consecutive rows and reads x by runs of planes whose
offsets follow one another (``plane_runs``, found once with the
operand): one window of R + M - 1 values serves a run's M planes, in
16-byte loads. On HPCG's 27-point band that is nine windows a lane
instead of 27 reads of R values; the sums keep their offset order, so Y
is the plain version's bit for bit. Each launch counts the reads the
windows replace in the tracer's ``dia.runs`` (K less the number of
runs: 18 on the 27-point band, 2 on the 7-point one). Each K5 product,
on the card or through the plain version, counts itself in
``dia.planes_calls`` and the bytes of its planes, x and y in
``dia.planes_bytes``.
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
from tpusparse_torch.utils import trace

# Masked DIA packs one validity bit per plane into a 32-bit word per row.
MASK_MAX_PLANES = 32
# K5 takes its offsets by value in kernel parameters (formats.dia.MAX_DIAGS).
PLANES_MAX = 64

# The DIA launches (K1, K5 here, K7 in dia_nmajor.py) open no kernel.*
# span of utils/trace.py, unlike the other kernels' launches. A solver
# makes one every iteration on the host's path from the convergence
# sync to the iteration's first kernel, and a span there added about 3
# points of device idle to a profiled CG loop on HPCG's 27-point stencil
# (H100).

# K1's geometry, mirrored from csrc/dia_masked.cu (kThreads, kRowBytes,
# kVectorBytes, kMaxRun) and checked against the library at every launch:
# threads a CTA, bytes of a thread's run of rows, bytes of a vector load
# of x, planes of the longest run of consecutive offsets that a thread
# reads as one window of x.
K1_THREADS = 256
K1_ROW_BYTES = 32
K1_VECTOR_BYTES = 16
K1_MAX_RUN = 3

# K5's geometry, mirrored from csrc/dia_planes.cu (kThreads, kRowBytes;
# kVectorBytes of csrc/dia_rows.cuh) and checked against the library at
# every launch: threads a CTA, bytes of a thread's run of rows, bytes of
# a vector store of y.
K5_THREADS = 256
K5_ROW_BYTES = 16
K5_VECTOR_BYTES = 16


def k1_geometry(itemsize: int) -> tuple:
    """(threads a CTA, rows a thread, values a vector load, planes of
    the longest run) of K1 (itemsize 4) or K1d (itemsize 8)."""
    return (K1_THREADS, K1_ROW_BYTES // itemsize,
            K1_VECTOR_BYTES // itemsize, K1_MAX_RUN)


def plane_runs(offsets) -> tuple:
    """K1's runs of a band's planes: the planes of each, in plane order.
    A run is a maximal sequence of planes whose offsets follow one
    another (off, off + 1, ...), cut every ``K1_MAX_RUN`` planes. K1
    reads x once for each run, as one window: HPCG's 27-point band is
    nine runs of three, lap3d's 7-point band (1, 1, 3, 1, 1), spaced
    planes runs of one."""
    runs = []
    for k, off in enumerate(offsets):
        if (k and off == offsets[k - 1] + 1
                and runs[-1] < K1_MAX_RUN):
            runs[-1] += 1
        else:
            runs.append(1)
    return tuple(runs)


def k5_geometry(itemsize: int) -> tuple:
    """(threads a CTA, rows a thread, values a vector store of y) of K5
    (itemsize 4: float32 and bf16 planes) or K5d (itemsize 8)."""
    return (K5_THREADS, K5_ROW_BYTES // itemsize,
            K5_VECTOR_BYTES // itemsize)


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
    ``vals_host``: the same K values as Python floats. ``runs``: the
    planes of each of K1's runs (``plane_runs``). ``c_offsets``,
    ``c_vals`` and ``c_runs`` hold the offsets, the values in ``vals``'
    type and the runs as the host arrays K1 (and K7, the first two) take
    by value; all are built once with the operand."""

    num_rows: int
    num_cols: int
    offsets: tuple
    vals: torch.Tensor
    mask: torch.Tensor
    vals_host: tuple
    c_offsets: ctypes.Array = dataclasses.field(init=False, repr=False,
                                                compare=False)
    c_vals: ctypes.Array = dataclasses.field(init=False, repr=False,
                                             compare=False)
    runs: tuple = dataclasses.field(init=False, compare=False)
    c_runs: ctypes.Array = dataclasses.field(init=False, repr=False,
                                             compare=False)

    def __post_init__(self):
        K = max(len(self.offsets), 1)
        scalar = (ctypes.c_double if self.vals.dtype == torch.float64
                  else ctypes.c_float)
        self.c_offsets = (ctypes.c_int * K)(*self.offsets)
        self.c_vals = (scalar * K)(*self.vals_host)
        self.runs = plane_runs(self.offsets)
        self.c_runs = (ctypes.c_int * K)(*self.runs)


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
    host = [vals.copy(), words.view(np.int32).copy()]
    with trace.span("plan.upload"):
        vals_dev, mask = (torch.from_numpy(a).to(device) for a in host)
    return DiaStreamDevice(num_rows, num_cols, offsets, vals_dev, mask,
                           tuple(float(v) for v in vals))


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
    L, n = XT.shape
    f64 = XT.dtype == torch.float64
    _build.geometry("tps_dia_masked_geometry", (XT.element_size(),),
                    k1_geometry(XT.element_size()), "K1", "dia_stream.py")
    Y = torch.empty((L, n), dtype=XT.dtype, device=XT.device)
    _build.launch("tps_dia_masked_f64" if f64 else "tps_dia_masked",
                  "K1d" if f64 else "K1", XT.device, D.mask.data_ptr(),
                  XT.data_ptr(), Y.data_ptr(), n, L, len(D.offsets),
                  ctypes.addressof(D.c_offsets), ctypes.addressof(D.c_vals),
                  len(D.runs), ctypes.addressof(D.c_runs))
    # the reads of x that the runs' windows replace
    trace.count("dia.runs", len(D.offsets) - len(D.runs))
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
    L, K, n = XT.shape[0], len(D.offsets), D.num_rows
    if n == 0 or L == 0 or K == 0:
        return torch.zeros((L, n), dtype=XT.dtype, device=XT.device)
    _build.geometry("tps_dia_planes_geometry", (XT.element_size(),),
                    k5_geometry(XT.element_size()), "K5", "dia_stream.py")
    Y = torch.empty((L, n), dtype=XT.dtype, device=XT.device)
    args = (XT.data_ptr(), Y.data_ptr(), n, D.num_cols, L, K,
            ctypes.addressof(D.c_offsets))
    if XT.dtype == torch.float64:
        _build.launch("tps_dia_planes_f64", "K5d", XT.device,
                      D.data.data_ptr(), *args)
    else:
        _build.launch("tps_dia_planes", "K5", XT.device, D.data.data_ptr(),
                      int(D.data.dtype == torch.bfloat16), *args)
    return Y


def spmm_dia_planes_t(D: DiaDevice, XT: torch.Tensor) -> torch.Tensor:
    """Transposed-layout product on value planes: XT (L, num_cols) in
    the planes' compute type (``planes_value_dtype``) -> A @ X as (L,
    num_rows). K5 (float32 or bf16 planes) or K5d (float64 planes) on a
    CUDA tensor, the plain version on a CPU tensor; any other device
    raises. Each call counts 1 in the tracer's ``dia.planes_calls`` and
    the bytes the product reads and writes as the operand lays them out
    in ``dia.planes_bytes``: the K planes, x and y."""
    _check_planes(D, XT)
    trace.count("dia.planes_calls")
    trace.count("dia.planes_bytes", D.data.numel() * D.data.element_size()
                + XT.shape[0] * (D.num_cols + D.num_rows) * XT.element_size())
    if XT.device.type == "cuda":
        return _launch_planes(D, XT)
    if XT.device.type == "cpu":
        return spmm_dia_planes_plain(D, XT)
    raise ValueError(f"no K5 path for device {XT.device}")
