"""K1's decomposition of the masked DIA product (``csrc/dia_masked.cu``)
emulated on the CPU, and the checks its wrapper makes.

A K1 CTA owns a block of consecutive rows (R a thread: 8 in float32, 4
in float64) and walks every lane. A thread reads a plane's R values of
x in 16-byte vectors from the address rounded down to 16 bytes and
shifts them into place, or element by element, zero outside [0, n),
where the run reaches past either end. ``emulate_k1`` walks the same
row blocks, threads, lanes and reads in numpy and asserts that every
vector read stays inside its lane; it is equal bit for bit to
``spmm_dia_masked_plain`` in float32 and float64 at several L on lap3d,
lap2d's offsets at odd n, a 32-plane band, 32 spaced planes, offsets
past n, K = 0 and n smaller than a row block, at every misalignment of
XT's lanes. The emulation imports no JAX: the card tests
(``test_torch_cuda.py``) hold K1's and K1d's Y to it.

A launch checks that geometry against the library's through
``_build.geometry`` (``test_torch_layers.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse_torch import plan_matrix
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import dia_stream

ROOT = Path(__file__).resolve().parent.parent
LS = (1, 3, 16, 33)
DTYPES = (torch.float32, torch.float64)


def random_band(n, offsets, seed):
    """(n, offsets, vals, words): random coefficients and random 32-bit
    mask words (bit 31 set on about half the rows)."""
    rng = np.random.default_rng(seed)
    return (n, tuple(offsets), rng.standard_normal(len(offsets)),
            rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32))


def _stencil(make):
    def build(dtype):
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        return plan_matrix(make().to_csr(), "auto", dtype=np_dtype,
                           device="cpu").dia
    return build


def _band(*args):
    def build(dtype):
        n, offsets, vals, words = random_band(*args)
        return dia_stream.from_mask_words(n, n, offsets, vals, words, "cpu",
                                          dtype)
    return build


# name -> dtype -> DiaStreamDevice on the CPU
K1_CASES = {
    "lap3d-40": _stencil(lambda: gen.make_laplacian_grid3d(40)),
    "lap2d-33": _stencil(lambda: gen.make_laplacian_grid2d(33)),
    "lap2d-2049-offsets-n5001": _band(5001, (-2049, -1, 0, 1, 2049), 1),
    "band-32": _band(3000, range(-16, 16), 2),
    "spaced-32": _band(30000, [1500 * k - 24000 for k in range(32)], 3),
    "past-n": _band(700, (-701, -5, 0, 3, 700, 900), 4),
    "k-0": _band(1500, (), 5),
    "n-300": _band(300, (-17, -1, 0, 1, 17), 6),
    "n-0": _band(0, (-1, 0, 1), 7),
}


def emulate_k1(D, XT, base=0, paths=None):
    """Y of K1's decomposition, in XT's type (numpy rounds each product
    and sum apart, as the kernel does). ``base`` is XT's storage offset
    in elements, modulo a vector: with the lane's start it decides each
    read's shift. Per row block, lane and plane, a thread whose run of R
    values lies inside [0, n) from its rounded-down address reads whole
    vectors (asserted to stay inside the lane), any other reads element
    by element, zeros outside [0, n); ``paths`` (a dict) counts the
    threads of each path and the shifts taken. In float32 it is K1's Y
    bit for bit, in float64 K1d's."""
    XT = np.asarray(XT)
    L, n = XT.shape
    threads, R, V = dia_stream.k1_geometry(XT.dtype.itemsize)
    B = threads * R
    vals = D.vals.cpu().numpy().astype(XT.dtype)
    words = D.mask.cpu().numpy().view(np.uint32)
    zero = XT.dtype.type(0)
    Y = np.zeros((L, n), XT.dtype)
    if paths is not None:
        paths.setdefault("vector", 0)
        paths.setdefault("element", 0)
        paths.setdefault("shifts", set())
    for r0 in range(0, n, B):
        i0 = r0 + R * np.arange(threads)
        i0 = i0[i0 < n]  # a thread past n returns
        rows = i0[:, None] + np.arange(R)
        valid = rows < n
        w = np.where(valid, words[np.minimum(rows, n - 1)], 0)
        for l in range(L):
            x = XT[l]
            acc = np.zeros(rows.shape, XT.dtype)
            for k, off in enumerate(D.offsets):
                c = i0 + off
                s = (base + l * n + c) % V
                vec = (c - s >= 0) & (c - s + R + V <= n)
                end = c - s + (R // V + (s > 0)) * V
                assert np.all(~vec | ((c - s >= 0) & (end <= n)))
                if paths is not None:
                    paths["vector"] += int(vec.sum())
                    paths["element"] += int((~vec).sum())
                    paths["shifts"] |= set(s[vec].tolist())
                j = rows + off
                xv = np.where((j >= 0) & (j < n), x[np.clip(j, 0, n - 1)],
                              zero)
                coef = np.where((w >> np.uint32(k)) & 1, vals[k], zero)
                acc = acc + coef * xv
            Y[l, rows[valid]] = acc[valid]
    return Y


def _xt(L, n, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((L, n))
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_reads_whole_vectors_away_from_the_ends(dtype):
    """On lap3d-40 every thread reads whole vectors but where a plane's
    run reaches past 0 or n: at most the threads within max|offset| + R
    rows of either end, per plane and lane."""
    D = K1_CASES["lap3d-40"](dtype)
    XT = _xt(3, D.num_cols, dtype, 5)
    paths = {}
    emulate_k1(D, XT.numpy(), paths=paths)
    _, R, V = dia_stream.k1_geometry(XT.element_size())
    edge = 2 * (max(abs(o) for o in D.offsets) + R + V) // R + 2
    assert 0 < paths["element"] <= edge * len(D.offsets) * 3
    assert paths["vector"] > 10 * paths["element"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_shifts_at_odd_n(dtype):
    """At odd n the lanes start at every misalignment, so the vector
    reads take every shift; XT whose storage starts mid-vector likewise."""
    D = K1_CASES["lap2d-2049-offsets-n5001"](dtype)
    XT = _xt(4, D.num_cols, dtype, 6)
    _, _, V = dia_stream.k1_geometry(XT.element_size())
    for base in range(V):
        paths = {}
        emulate_k1(D, XT.numpy(), base, paths)
        assert paths["shifts"] == set(range(V))


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(K1_CASES))
def test_emulated_k1_equals_plain_bitwise(name, dtype, L):
    D = K1_CASES[name](dtype)
    XT = _xt(L, D.num_cols, dtype, 17 + L)
    Y = emulate_k1(D, XT.numpy())
    np.testing.assert_array_equal(
        Y, dia_stream.spmm_dia_masked_plain(D, XT).numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["lap2d-33", "lap2d-2049-offsets-n5001",
                                  "spaced-32", "n-300"])
def test_emulated_k1_at_every_misalignment(name, dtype):
    """Odd n moves each lane's reads against the 16-byte boundaries; so
    does an XT whose storage starts between them (``base``)."""
    D = K1_CASES[name](dtype)
    XT = _xt(3, D.num_cols, dtype, 29)
    want = dia_stream.spmm_dia_masked_plain(D, XT).numpy()
    _, _, V = dia_stream.k1_geometry(XT.element_size())
    for base in range(V):
        np.testing.assert_array_equal(emulate_k1(D, XT.numpy(), base), want)


def _constants(path, names):
    """The named constants of a csrc source and of the DIA kernels' shared
    header (``dia_rows.cuh``)."""
    csrc = ROOT / "tpusparse_torch" / "csrc"
    src = (csrc / path).read_text() + (csrc / "dia_rows.cuh").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
            for k in names}


def test_geometry_mirrors_the_source():
    """``k1_geometry`` is built from csrc/dia_masked.cu's constants; it
    is what every launch checks against the library."""
    c = _constants("dia_masked.cu", ("kThreads", "kRowBytes",
                                     "kVectorBytes"))
    assert c["kThreads"] == dia_stream.K1_THREADS
    assert c["kRowBytes"] == dia_stream.K1_ROW_BYTES
    assert c["kVectorBytes"] == dia_stream.K1_VECTOR_BYTES
    for itemsize in (4, 8):
        assert dia_stream.k1_geometry(itemsize) == (
            c["kThreads"], c["kRowBytes"] // itemsize,
            c["kVectorBytes"] // itemsize)
