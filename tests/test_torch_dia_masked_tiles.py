"""K1's decomposition of the masked DIA product (``csrc/dia_masked.cu``)
emulated on the CPU, and the checks its wrapper makes.

A K1 CTA owns a block of consecutive rows (R a thread: 8 in float32, 4
in float64) and walks every lane. A thread reads x one run of planes at
a time (``dia_stream.plane_runs``: consecutive offsets, at most
``K1_MAX_RUN`` planes): the R + M - 1 values of a run of M planes as one
window, in 16-byte vectors from the address rounded down to 16 bytes,
shifted into place, or element by element, zero outside [0, n), where
the window reaches past either end. ``emulate_k1`` walks the same row
blocks, threads, lanes, runs and reads in numpy (whole vectors only
where they lie inside the lane); it is equal bit for bit to
``spmm_dia_masked_plain`` in float32 and float64 at several L on lap3d,
HPCG's 27-point band at odd, even and mixed widths, a grid so small that
its 27 planes are one run, lap2d's offsets at odd n, a 32-plane band
(one run, cut by the cap), 32 spaced planes (no run), runs whose windows
cross row 0 and row n - 1, offsets past n, K = 0 and n smaller than a
row block, at every misalignment of XT's lanes. The emulation imports no
JAX: the card tests (``test_torch_cuda.py``) hold K1's and K1d's Y to
it.

A launch checks that geometry against the library's through
``_build.geometry`` (``test_torch_layers.py``), passes the operand's
runs and counts the reads their windows replace in ``dia.runs``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse_torch import plan_matrix
from tpusparse_torch.formats.coo import CooMatrix
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import _build, dia_stream
from tpusparse_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent
LS = (1, 3, 16, 33)
DTYPES = (torch.float32, torch.float64)


def random_band(n, offsets, seed):
    """(n, offsets, vals, words): random coefficients and random 32-bit
    mask words (bit 31 set on about half the rows)."""
    rng = np.random.default_rng(seed)
    return (n, tuple(offsets), rng.standard_normal(len(offsets)),
            rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32))


def hpcg27(nx, ny, nz) -> CooMatrix:
    """HPCG's 27-point stencil on an nx x ny x nz grid (x fastest): 26 on
    the diagonal, -1 for each neighbour present."""
    def t(w):
        return sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(w, w))
    n = nx * ny * nz
    m = (27.0 * sp.eye(n) - sp.kron(sp.kron(t(nz), t(ny)), t(nx))).tocoo()
    return CooMatrix(n, n, m.row, m.col, m.data)


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
    "hpcg27-7": _stencil(lambda: hpcg27(7, 7, 7)),
    "hpcg27-8": _stencil(lambda: hpcg27(8, 8, 8)),
    "hpcg27-9x7x5": _stencil(lambda: hpcg27(9, 7, 5)),
    "hpcg27-3": _stencil(lambda: hpcg27(3, 3, 3)),
    "lap2d-33": _stencil(lambda: gen.make_laplacian_grid2d(33)),
    "lap2d-2049-offsets-n5001": _band(5001, (-2049, -1, 0, 1, 2049), 1),
    "band-32": _band(3000, range(-16, 16), 2),
    "spaced-32": _band(30000, [1500 * k - 24000 for k in range(32)], 3),
    "past-n": _band(700, (-701, -5, 0, 3, 700, 900), 4),
    "edge-runs": _band(1000, (-999, -998, -997, -2, -1, 0, 1, 2, 997, 998,
                              999), 8),
    "k-0": _band(1500, (), 5),
    "n-300": _band(300, (-17, -1, 0, 1, 17), 6),
    "n-0": _band(0, (-1, 0, 1), 7),
}


def emulate_k1(D, XT, base=0, paths=None):
    """Y of K1's decomposition, in XT's type (numpy rounds each product
    and sum apart, as the kernel does). ``base`` is XT's storage offset
    in elements, modulo a vector: with the lane's start it decides each
    read's shift. Per row block, lane and run of M planes, a thread reads
    the window of W = R + M - 1 values from the run's first offset, which
    lies s elements past a vector boundary: the ceil((s + W) / V) whole
    vectors it spans from the rounded-down address where they lie inside
    [0, n) (so inside the lane), else element by element, zeros outside
    [0, n). The run's planes take their values from the window, in plane
    order. ``paths`` (a dict) counts the
    threads of each path and the shifts taken. In float32 it is K1's Y
    bit for bit, in float64 K1d's."""
    XT = np.asarray(XT)
    L, n = XT.shape
    threads, R, V, max_run = dia_stream.k1_geometry(XT.dtype.itemsize)
    B = threads * R
    vals = D.vals.cpu().numpy().astype(XT.dtype)
    words = D.mask.cpu().numpy().view(np.uint32)
    assert sum(D.runs) == len(D.offsets) and max(D.runs, default=1) <= max_run
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
            k = 0
            for m in D.runs:
                W = R + m - 1
                c = i0 + D.offsets[k]
                s = (base + l * n + c) % V
                end = c - s + -(-(s + W) // V) * V
                vec = (c - s >= 0) & (end <= n)
                if paths is not None:
                    paths["vector"] += int(vec.sum())
                    paths["element"] += int((~vec).sum())
                    paths["shifts"] |= set(s[vec].tolist())
                j = c[:, None] + np.arange(W)
                window = np.where((j >= 0) & (j < n),
                                  x[np.clip(j, 0, n - 1)], zero)
                for q in range(m):
                    assert D.offsets[k + q] == D.offsets[k] + q
                    coef = np.where((w >> np.uint32(k + q)) & 1, vals[k + q],
                                    zero)
                    acc = acc + coef * window[:, q:q + R]
                k += m
            Y[l, rows[valid]] = acc[valid]
    return Y


def _xt(L, n, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((L, n))
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["lap3d-40", "hpcg27-8"])
def test_k1_reads_whole_vectors_away_from_the_ends(name, dtype):
    """Every thread reads whole vectors but where a run's window reaches
    past 0 or n: at most the threads within max|offset| plus a window
    and two vectors of either end, per run and lane."""
    D = K1_CASES[name](dtype)
    XT = _xt(3, D.num_cols, dtype, 5)
    paths = {}
    emulate_k1(D, XT.numpy(), paths=paths)
    _, R, V, max_run = dia_stream.k1_geometry(XT.element_size())
    reach = max(abs(o) for o in D.offsets) + R + max_run + 2 * V
    edge = 2 * reach // R + 2
    assert 0 < paths["element"] <= edge * len(D.runs) * 3
    if name == "lap3d-40":
        assert paths["vector"] > 10 * paths["element"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_shifts_at_odd_n(dtype):
    """At odd n the lanes start at every misalignment, so the vector
    reads take every shift; XT whose storage starts mid-vector likewise."""
    D = K1_CASES["lap2d-2049-offsets-n5001"](dtype)
    XT = _xt(4, D.num_cols, dtype, 6)
    V = dia_stream.k1_geometry(XT.element_size())[2]
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
                                  "spaced-32", "n-300", "hpcg27-7",
                                  "hpcg27-8", "hpcg27-9x7x5", "hpcg27-3",
                                  "band-32", "edge-runs"])
def test_emulated_k1_at_every_misalignment(name, dtype):
    """Odd n moves each lane's reads against the 16-byte boundaries; so
    does an XT whose storage starts between them (``base``)."""
    D = K1_CASES[name](dtype)
    XT = _xt(3, D.num_cols, dtype, 29)
    want = dia_stream.spmm_dia_masked_plain(D, XT).numpy()
    V = dia_stream.k1_geometry(XT.element_size())[2]
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
                                     "kVectorBytes", "kMaxRun"))
    assert c["kThreads"] == dia_stream.K1_THREADS
    assert c["kRowBytes"] == dia_stream.K1_ROW_BYTES
    assert c["kVectorBytes"] == dia_stream.K1_VECTOR_BYTES
    assert c["kMaxRun"] == dia_stream.K1_MAX_RUN
    for itemsize in (4, 8):
        assert dia_stream.k1_geometry(itemsize) == (
            c["kThreads"], c["kRowBytes"] // itemsize,
            c["kVectorBytes"] // itemsize, c["kMaxRun"])


@pytest.mark.parametrize("name,runs", [
    ("hpcg27-8", (3,) * 9),
    ("hpcg27-9x7x5", (3,) * 9),
    ("hpcg27-3", (3,) * 9),
    ("lap3d-40", (1, 1, 3, 1, 1)),
    ("band-32", (3,) * 10 + (2,)),
    ("spaced-32", (1,) * 32),
    ("edge-runs", (3, 3, 2, 3)),
    ("k-0", ()),
])
def test_runs_are_maximal_consecutive_offsets_cut_by_the_cap(name, runs):
    """An operand's runs cover its planes in order; a run's offsets
    follow one another, and a run stops only at a gap or at the cap."""
    D = K1_CASES[name](torch.float64)
    assert D.runs == runs == dia_stream.plane_runs(D.offsets)
    k = 0
    for m in D.runs:
        assert 1 <= m <= dia_stream.K1_MAX_RUN
        assert list(D.offsets[k:k + m]) == list(range(D.offsets[k],
                                                      D.offsets[k] + m))
        end = k + m
        if end < len(D.offsets) and m < dia_stream.K1_MAX_RUN:
            assert D.offsets[end] != D.offsets[end - 1] + 1
        k = end
    assert k == len(D.offsets)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,replaced", [("hpcg27-8", 18),
                                           ("lap3d-40", 2),
                                           ("spaced-32", 0),
                                           ("band-32", 21)])
def test_launch_passes_the_runs_and_counts_the_reads_they_replace(
        monkeypatch, name, dtype, replaced):
    """A K1 (K1d) launch hands the library the operand's runs and adds K
    less the number of runs to ``dia.runs`` when the tracer is on: 18 on
    the 27-point band, 2 on the 7-point one, 0 on spaced planes."""
    D = K1_CASES[name](dtype)
    XT = torch.zeros((2, D.num_cols), dtype=dtype)
    calls = []
    monkeypatch.setattr(_build, "geometry", lambda *args: None)
    monkeypatch.setattr(_build, "launch", lambda *args: calls.append(args))
    trace.take()
    trace.enable()
    try:
        dia_stream._launch(D, XT)
        trace.disable()
        dia_stream._launch(D, XT)
    finally:
        trace.disable()
        _, counters = trace.take()
    assert sum(counters["dia.runs"].values()) == replaced
    assert len(calls) == 2
    *_, num_runs, runs = calls[0]
    assert num_runs == len(D.runs)
    assert tuple((ctypes.c_int * num_runs).from_address(runs)) == D.runs
