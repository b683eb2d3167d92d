"""K5's decomposition of the value-plane DIA product
(``csrc/dia_planes.cu``) emulated on the CPU, and the checks its wrapper
makes.

A K5 CTA owns a block of consecutive rows (R a thread: 4 with float32
and bf16 planes, 2 with float64 planes) and walks every lane, one at a
time. For each plane in offset order a thread takes its R plane values
(from global memory, or at L > 1 after the first lane from the CTA's
shared-memory tile: the same values) and adds their products with its R
values of x at the plane's offset, zero outside [0, num_cols), into the
lane's accumulators. ``emulate_k5`` walks the same row blocks, threads,
lanes and planes in numpy; it is equal bit for bit to
``spmm_dia_planes_plain`` with float32, bf16 and float64 planes at
several L on var-7, var-27, rectangular bands, offsets past n, K = 0,
K = 64 and n smaller than a row block. The emulation imports no JAX:
the card tests (``test_torch_cuda.py``) hold K5's and K5d's Y to it.

A launch checks that geometry against the library's through
``_build.geometry`` (``test_torch_layers.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse_torch import plan_dia_bf16, plan_matrix
from tpusparse_torch.formats.dia import (
    DiaDevice,
    partition_dia,
    select_diagonals,
    to_device_dia,
)
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import dia_stream

ROOT = Path(__file__).resolve().parent.parent
LS = (1, 3, 16, 33)
PLANE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _stencil(make):
    """Value planes of a generator's matrix, in the plane type asked."""
    def build(plane_dtype):
        csr = make().to_csr()
        if plane_dtype == torch.bfloat16:
            return plan_dia_bf16(csr, device="cpu").dia
        np_dtype = (np.float64 if plane_dtype == torch.float64
                    else np.float32)
        return plan_matrix(csr, "dia", dtype=np_dtype, device="cpu").dia
    return build


def _band(num_rows, num_cols, offsets, seed):
    """Random value planes on ``offsets``, random values also where a
    plane's column falls outside [0, num_cols) (x reads 0 there)."""
    def build(plane_dtype):
        rng = np.random.default_rng(seed)
        data = rng.standard_normal((len(offsets), num_rows))
        host = torch.from_numpy(data.astype(
            np.float64 if plane_dtype == torch.float64 else np.float32))
        return DiaDevice(num_rows, num_cols, tuple(offsets),
                         host.to(plane_dtype).contiguous())
    return build


# name -> plane dtype -> DiaDevice on the CPU
K5_CASES = {
    "var-7-15": _stencil(lambda: gen.make_variable_stencil(
        15, dims=3, shift=1.0, seed=0)),
    "var-27-13": _stencil(lambda: gen.make_variable_stencil(
        13, dims=3, full=True, shift=1.0, seed=2)),
    "rect-3000x3005": _band(3000, 3005, (-2, 0, 1, 5), 1),
    "rect-3005x3000": _band(3005, 3000, (-7, -1, 0, 3), 2),
    "past-n": _band(700, 700, (-701, -5, 0, 3, 700, 900), 3),
    "k-0": _band(1500, 1500, (), 4),
    "k-64": _band(5001, 5001, tuple(range(-32, 32)), 5),
    "n-300": _band(300, 300, (-17, -1, 0, 1, 17), 6),
}


def _value_dtype(plane_dtype):
    return torch.float64 if plane_dtype == torch.float64 else torch.float32


def emulate_k5(D, XT):
    """Y of K5's decomposition, in XT's type (numpy rounds each product
    and sum apart, as the kernel does): per row block, lane and plane,
    each thread's R rows, x read as zero outside [0, num_cols). With
    float32 or bf16 planes it is K5's Y bit for bit, with float64 planes
    K5d's."""
    XT = np.asarray(XT)
    L, m = XT.shape
    n = D.num_rows
    dt = XT.dtype
    threads, R, _ = dia_stream.k5_geometry(dt.itemsize)
    planes = D.data.to(torch.float64).numpy().astype(dt)  # exact upcast
    zero = dt.type(0)
    Y = np.zeros((L, n), dt)
    for r0 in range(0, n, threads * R):
        i0 = r0 + R * np.arange(threads)
        i0 = i0[i0 < n]  # a thread past num_rows returns
        rows = i0[:, None] + np.arange(R)
        valid = rows < n
        for l in range(L):
            acc = np.zeros(rows.shape, dt)
            for k, off in enumerate(D.offsets):
                d = np.where(valid, planes[k, np.minimum(rows, n - 1)], zero)
                j = rows + off
                xv = np.where((j >= 0) & (j < m),
                              XT[l][np.clip(j, 0, max(m - 1, 0))], zero)
                acc = acc + d * xv
            Y[l, rows[valid]] = acc[valid]
    return Y


def _xt(L, m, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((L, m))
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("plane_dtype", PLANE_DTYPES)
@pytest.mark.parametrize("name", list(K5_CASES))
def test_emulated_k5_equals_plain_bitwise(name, plane_dtype, L):
    D = K5_CASES[name](plane_dtype)
    XT = _xt(L, D.num_cols, _value_dtype(plane_dtype), 17 + L)
    Y = emulate_k5(D, XT.numpy())
    np.testing.assert_array_equal(
        Y, dia_stream.spmm_dia_planes_plain(D, XT).numpy())


@pytest.mark.parametrize("L", (1, 16))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_emulated_k5_equals_k1_on_a_constant_band(dtype, L):
    """On a constant-coefficient band K5's value planes give K1's masked
    product bit for bit."""
    csr = gen.make_laplacian_grid3d(14).to_csr()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    M = plan_matrix(csr, "dia", dtype=np_dtype, device="cpu").dia
    assert isinstance(M, dia_stream.DiaStreamDevice)
    host, _ = partition_dia(csr, select_diagonals(csr))
    D = to_device_dia(host, "cpu", plane_dtype=dtype)
    XT = _xt(L, csr.num_cols, dtype, 31)
    np.testing.assert_array_equal(
        emulate_k5(D, XT.numpy()),
        dia_stream.spmm_dia_masked_plain(M, XT).numpy())


def _constants(path, names):
    """The named constants of a csrc source and of the DIA kernels' shared
    header (``dia_rows.cuh``)."""
    csrc = ROOT / "tpusparse_torch" / "csrc"
    src = (csrc / path).read_text() + (csrc / "dia_rows.cuh").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
            for k in names}


def test_geometry_mirrors_the_source():
    """``k5_geometry`` is built from csrc/dia_planes.cu's constants; it
    is what every launch checks against the library."""
    c = _constants("dia_planes.cu", ("kThreads", "kRowBytes",
                                     "kVectorBytes"))
    assert c["kThreads"] == dia_stream.K5_THREADS
    assert c["kRowBytes"] == dia_stream.K5_ROW_BYTES
    assert c["kVectorBytes"] == dia_stream.K5_VECTOR_BYTES
    for itemsize in (4, 8):
        assert dia_stream.k5_geometry(itemsize) == (
            c["kThreads"], c["kRowBytes"] // itemsize,
            c["kVectorBytes"] // itemsize)
