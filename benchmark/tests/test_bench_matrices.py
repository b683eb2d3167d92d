"""The generators and plain reference products of the configurations."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import harness
from conftest import ROOT

HPCG = json.loads((ROOT / "benchmark/configs/hpcg-27pt-208.json").read_text())
RMAT = json.loads(
    (ROOT / "benchmark/configs/graph500-rmat-s25.json").read_text())
hpcg27 = harness.load_module(ROOT / "benchmark/matrices/hpcg27.py")
rmat = harness.load_module(ROOT / "benchmark/matrices/rmat.py")


def _scipy(p):
    return sp.csr_matrix((p["values"], p["col_indices"], p["row_offsets"]),
                         shape=(p["num_rows"], p["num_cols"]))


def _hpcg_scipy(nx, ny, nz):
    """The 27-point matrix as HPCG's GenerateProblem_ref loops build it."""
    rows, cols, vals = [], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                r = (iz * ny + iy) * nx + ix
                for dz in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            jx, jy, jz = ix + dx, iy + dy, iz + dz
                            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                                rows.append(r)
                                cols.append((jz * ny + jy) * nx + jx)
                                vals.append(26.0 if (dx, dy, dz) == (0, 0, 0)
                                            else -1.0)
    n = nx * ny * nz
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 4, 3)])
def test_hpcg_matches_scipy_construction(dims):
    nx, ny, nz = dims
    cfg = dict(HPCG, nx=nx, ny=ny, nz=nz)
    p = hpcg27.generate(cfg, None, "cpu")
    A, ref = _scipy(p), _hpcg_scipy(nx, ny, nz)
    assert p["values"].dtype == np.float64
    assert p["row_offsets"].dtype == np.int32
    assert (A != ref).nnz == 0
    counts = np.diff(p["row_offsets"])
    assert counts.max() == 27 and counts.min() == 8
    assert A.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    np.testing.assert_array_equal(A.diagonal(), 26.0)
    # row sums: 26 - (neighbours present) = 27 - count
    np.testing.assert_array_equal(np.asarray(A.sum(1)).ravel(), 27 - counts)
    for r in range(A.shape[0]):
        cols = p["col_indices"][p["row_offsets"][r]:p["row_offsets"][r + 1]]
        assert np.all(np.diff(cols) > 0)


def test_hpcg_counts_in_config():
    nx = HPCG["nx"]
    assert HPCG["num_rows"] == nx ** 3
    assert HPCG["nnz"] == (3 * nx - 2) ** 3 == 240_641_848


@pytest.mark.parametrize("L", [1, 3])
def test_hpcg_stencil_is_the_matrix(L):
    cfg = dict(HPCG, nx=6, ny=5, nz=4)
    p = hpcg27.generate(cfg, None, "cpu")
    A = _scipy(p)
    X = torch.randn((A.shape[0], L) if L > 1 else (A.shape[0],),
                    dtype=torch.float64)
    got = hpcg27.reference_matmat(cfg, p, X)
    np.testing.assert_allclose(got.numpy(), A @ X.numpy(), rtol=1e-14,
                               atol=1e-12)
    got_abs = hpcg27.reference_matmat(cfg, p, X, absolute=True)
    np.testing.assert_allclose(got_abs.numpy(), abs(A) @ X.abs().numpy(),
                               rtol=1e-14, atol=1e-12)


def _rmat(scale, seed=3):
    cfg = dict(RMAT, scale=scale)
    return cfg, rmat.generate(cfg, harness.generator(seed, "matrix", "cpu"),
                              "cpu")


def test_rmat_counts_and_mirror():
    cfg, p = _rmat(10)
    n = 1 << 10
    assert p["num_rows"] == n
    assert p["col_indices"].shape[0] == 2 * 16 * n
    assert p["row_offsets"][-1] == 2 * 16 * n
    assert p["values"].dtype == np.float32
    ro, ci = p["row_offsets"].astype(np.int64), p["col_indices"]
    rows = np.repeat(np.arange(n), np.diff(ro))
    key = rows * n + ci
    assert np.all(np.diff(key) >= 0)  # sorted by (row, column)
    # the pattern, with multiplicities, is its own transpose
    np.testing.assert_array_equal(np.sort(key), np.sort(ci * n + rows))


def test_rmat_graph_from_config_values_from_seed():
    """The configuration's graph_seed fixes the graph; the run's seed
    draws the values."""
    _, a = _rmat(8, seed=11)
    _, b = _rmat(8, seed=11)
    _, c = _rmat(8, seed=12)
    for k in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("row_offsets", "col_indices"):
        np.testing.assert_array_equal(a[k], c[k])
    assert not np.array_equal(a["values"], c["values"])
    cfg = dict(RMAT, scale=8, graph_seed=RMAT["graph_seed"] + 1)
    d = rmat.generate(cfg, harness.generator(11, "matrix", "cpu"), "cpu")
    assert not np.array_equal(a["col_indices"], d["col_indices"])


def test_rmat_initiator_shares():
    """Every level draws its quadrant with the initiator's shares."""
    scale, m = 10, 16 << 10
    gen = harness.generator(5, "matrix", "cpu")
    rows, cols = rmat.kronecker_edges(scale, m, RMAT["A"], RMAT["B"],
                                      RMAT["C"], gen, "cpu")
    counts = np.zeros(4)
    for level in range(scale):
        r = ((rows >> level) & 1).numpy()
        c = ((cols >> level) & 1).numpy()
        counts += np.bincount(2 * r + c, minlength=4)
    share = counts / counts.sum()
    want = np.array([RMAT["A"], RMAT["B"], RMAT["C"],
                     1 - RMAT["A"] - RMAT["B"] - RMAT["C"]])
    sigma = np.sqrt(want * (1 - want) / counts.sum())
    assert np.all(np.abs(share - want) < 5 * sigma), (share, want)


@pytest.mark.parametrize("L", [1, 4])
def test_rmat_reference_product(L, monkeypatch):
    cfg, p = _rmat(8)
    monkeypatch.setattr(rmat, "REFERENCE_BLOCK", 1000)  # several blocks
    A = _scipy(p).astype(np.float64)
    # |A| entry by entry, duplicates apart (scipy's abs sums them first)
    absA = _scipy(dict(p, values=np.abs(p["values"]))).astype(np.float64)
    X = torch.randn((A.shape[0], L) if L > 1 else (A.shape[0],),
                    dtype=torch.float64)
    np.testing.assert_allclose(rmat.reference_matmat(cfg, p, X).numpy(),
                               A @ X.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        rmat.reference_matmat(cfg, p, X, absolute=True).numpy(),
        absA @ X.abs().numpy(), rtol=1e-12, atol=1e-12)
