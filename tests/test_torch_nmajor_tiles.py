"""K7's decomposition of the n-major masked DIA product
(``csrc/dia_nmajor.cu``) emulated on the CPU, and the checks its wrapper
makes.

A K7 CTA walks ``K7_SUB_BLOCKS`` sub-blocks of rows in order (one, as
the card's A/B left it). A sub-block has ``runs`` row slots of
consecutive rows, and R times as many rows; a thread owns one lane group
of V values (the L / V threads of a row are neighbours) in R rows, its
slot and the slots ``runs``, 2 ``runs``, ... rows further on. It loads
its R mask words once, and for each plane in offset order reads its R
rows of x at that offset, V values a row, and adds their products into
its R x V accumulators; a thread whose rows reach past row 0 or row n
takes guarded loads, which read 0 outside [0, n). ``emulate_k7`` walks
the same CTAs, sub-blocks, slots, lane groups and planes in numpy; it is
equal bit for
bit to ``spmm_nmajor_plain`` at L = 2, 3, 4, 5, 16, 33 and 128 with
every lane group that divides L, on lap3d and lap2d bands, offsets past
n, K = 0, K = 32 and n smaller than one CTA's block. The emulation
imports no JAX: the card tests (``test_torch_cuda.py``) hold K7's Y to
it.

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
from tpusparse_torch.kernels import dia_nmajor, dia_stream

ROOT = Path(__file__).resolve().parent.parent
LS = (2, 3, 4, 5, 16, 33, 128)


def _stencil(make):
    def build():
        return plan_matrix(make().to_csr(), "nmajor", L=2, dtype=np.float32,
                           device="cpu").dia
    return build


def _band(n, offsets, seed):
    """Random coefficients and random 32-bit mask words (bit 31 set on
    about half the rows) on ``offsets``."""
    def build():
        rng = np.random.default_rng(seed)
        words = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        band = dia_stream.from_mask_words(n, n, offsets,
                                          rng.standard_normal(len(offsets)),
                                          words, "cpu")
        return dia_nmajor.DiaNMajorDevice(band, 128)
    return build


# name -> DiaNMajorDevice on the CPU
K7_CASES = {
    "lap3d-9": _stencil(lambda: gen.make_laplacian_grid3d(9)),
    "lap2d-33": _stencil(lambda: gen.make_laplacian_grid2d(33)),
    "lap2d-2000-offsets-n5001": _band(5001, (-2000, -1, 0, 1, 2000), 1),
    "past-n": _band(700, (-701, -5, 0, 3, 700, 900), 2),
    "k-0": _band(1500, (), 3),
    "k-32": _band(1001, tuple(range(-16, 16)), 4),
    "n-50": _band(50, (-7, -1, 0, 1, 7), 5),
}


def emulate_k7(D, X, V, runs_seen=None):
    """Y of K7's decomposition with lane groups of V values, float32
    (numpy rounds each product and sum apart, as the kernel does). Per
    CTA, sub-block and plane, every thread's R rows (``runs`` apart) and
    every lane group of V values; a thread whose R rows at the plane's
    offset lie inside [0, n) reads them whole, any other reads each row
    guarded. ``runs_seen`` (a dict) counts the whole and guarded
    reads."""
    X = np.asarray(X, np.float32)
    n, L = X.shape
    assert L % V == 0
    geo = dia_nmajor.k7_geometry(L, V)
    R, runs, G = geo["rows"], geo["runs"], geo["groups"]
    words = D.band.mask.cpu().numpy().view(np.uint32)
    vals = np.asarray(D.band.vals_host, np.float32)
    zero = np.float32(0)
    # a thread's lane group: columns g V .. g V + V - 1 of its rows
    lanes = (np.arange(G)[:, None] * V + np.arange(V)).reshape(-1)
    Y = np.full((n, L), np.nan, np.float32)
    for cta0 in range(0, n, geo["cta_rows"]):
        for s in range(geo["sub_blocks"]):
            i0 = cta0 + s * runs * R + np.arange(runs)
            i0 = i0[i0 < n]  # a thread whose first row is past n returns
            rows = i0[:, None] + runs * np.arange(R)  # (threads, R)
            w = np.where(rows < n, words[np.minimum(rows, n - 1)], 0)
            acc = np.zeros(rows.shape + (L,), np.float32)
            for k, off in enumerate(D.offsets):
                j0 = i0 + off
                whole = (j0 >= 0) & (j0 + (R - 1) * runs < n)
                if runs_seen is not None:
                    runs_seen["whole"] += int(whole.sum())
                    runs_seen["guarded"] += int((~whole).sum())
                j = rows + off
                xv = np.zeros(rows.shape + (L,), np.float32)
                xv[whole] = X[j[whole]][..., lanes]
                ok = ~whole[:, None] & (j >= 0) & (j < n)
                xv[ok] = X[j[ok]][..., lanes]
                c = np.where((w >> np.uint32(k)) & 1, vals[k], zero)
                acc = acc + c[..., None] * xv
            keep = rows < n
            Y[rows[keep]] = acc[keep]
    return Y


def _x(n, L, seed):
    x = np.random.default_rng(seed).standard_normal((n, L))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("name", list(K7_CASES))
def test_emulated_k7_equals_plain_bitwise(name, L):
    """Every lane group that divides L: 4, 2 or 1 values (the wrapper
    narrows it for a misaligned X)."""
    D = K7_CASES[name]()
    X = _x(D.num_rows, L, 60 + L)
    Yp = dia_nmajor.spmm_nmajor_plain(D.band, X).numpy()
    for V in (v for v in (4, 2, 1) if L % v == 0):
        np.testing.assert_array_equal(emulate_k7(D, X.numpy(), V), Yp)


def test_k7_runs_are_guarded_only_at_the_ends():
    """On lap3d-9 at L = 16 (729 rows over three CTAs of 256) the reads
    of the threads whose rows at the +-81, +-9 or +-1 planes reach past
    row 0 or row n are guarded, most others whole; the n-50 band at L =
    3 is less than one CTA's block (340 rows), so every thread's rows
    reach past n and every read is guarded."""
    for name, L, V, ctas in (("lap3d-9", 16, 4, 3), ("n-50", 3, 1, 1)):
        D = K7_CASES[name]()
        seen = {"whole": 0, "guarded": 0}
        emulate_k7(D, _x(D.num_rows, L, 7).numpy(), V, seen)
        assert seen["guarded"] > 0
        if name == "n-50":
            assert seen["whole"] == 0
        else:
            assert seen["whole"] > 2 * seen["guarded"]
        cta_rows = dia_nmajor.k7_geometry(L, V)["cta_rows"]
        assert -(-D.num_rows // cta_rows) == ctas


def test_k7_lane_group_follows_l_and_alignment():
    """V is 4 where L % 4 == 0 and the pointers sit on 16 bytes, else the
    widest that fits."""
    for L, want in ((2, 2), (3, 1), (4, 4), (5, 1), (6, 2), (16, 4),
                    (33, 1), (128, 4)):
        assert dia_nmajor.k7_lane_group(L, torch.zeros(8, L)) == want
    flat = torch.zeros(8 * 16 + 2)
    assert dia_nmajor.k7_lane_group(16, flat[1:129]) == 1
    assert dia_nmajor.k7_lane_group(16, flat[2:130]) == 2


def _constants(names):
    src = (ROOT / "tpusparse_torch" / "csrc" / "dia_nmajor.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
            for k in names}


def test_geometry_mirrors_the_source():
    """``k7_geometry`` is built from csrc/dia_nmajor.cu's constants; they
    are what every launch checks against the library."""
    c = _constants(("kThreads", "kRows", "kSubBlocks", "kVectorBytes"))
    assert (c["kThreads"], c["kRows"], c["kSubBlocks"], c["kVectorBytes"]) \
        == (dia_nmajor.K7_THREADS, dia_nmajor.K7_ROWS,
            dia_nmajor.K7_SUB_BLOCKS, dia_nmajor.K7_VECTOR_BYTES)
    geo = dia_nmajor.k7_geometry(16, 4)
    assert geo["groups"] == 4 and geo["runs"] == c["kThreads"] // 4
    assert geo["cta_rows"] == c["kSubBlocks"] * geo["runs"] * c["kRows"]
