"""K2's merge-path tiles in the plan (``merge_spmv.merge_tile_coords``)
and the alpha = 1 path of the merge and row-split wrappers.

The plan finds the start (row, nonzero) of every tile of K2 once, with a
numpy binary search; these tests hold it to a walk of the merge path in
a Python loop on edge cases (num_rows = 0, nnz = 0, empty rows, the
rectangular ``bibd_9_3``, a wheel hub spanning several tiles) and at
several tile sizes, the last entry being (num_rows, nnz). A float64
emulation of the tile decomposition (each tile's completed rows and
carry-out, then the carry fix-up in tile order, as K2 does) gives the
exact row sums of integer-valued matrices, so the tiles cover every item
of the path once. Plans built any other way (a carried JAX plan, a
hybrid's remainder, a reordered plan's inner plan) carry the same
coordinates. At alpha = 1 (and beta = 0) ``spmv`` and ``spmm`` give back
the kernel's output itself, with no elementwise multiply.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse.io import generators as jgen
from tpusparse_torch import CsrMatrix, plan_matrix, spmm, spmv
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.kernels import merge_spmv
from tpusparse_torch.ops import spmv as dispatch
from tpusparse_torch.ops.hybrid import HybridPlan
from tpusparse_torch.ops.reorder import ReorderedPlan
from tpusparse_torch.utils.carry import plan_from_arrays

ROOT = Path(__file__).resolve().parent.parent
TILE = merge_spmv.TILE_ITEMS

CASES = {
    "n-0": lambda: CsrMatrix(0, 3, np.zeros(1, np.int32),
                             np.zeros(0, np.int32), np.zeros(0)),
    "nnz-0": lambda: CsrMatrix(4, 4, np.zeros(5, np.int32),
                               np.zeros(0, np.int32), np.zeros(0)),
    "empty-rows": lambda: CsrMatrix(6, 5, np.array([0, 0, 2, 2, 2, 3, 3]),
                                    np.array([1, 4, 0]),
                                    np.array([1.0, 2.0, 3.0])),
    "bibd_9_3": lambda: read_market(ROOT / "data/real/bibd_9_3.mtx").to_csr(),
    "wheel-5000": lambda: gen.make_wheel(5000).to_csr(),
    "rmat-10": lambda: gen.make_rmat(10).to_csr(),
}


def _walk(row_offsets, nnz, tile):
    """Tile starts by walking the merge path one item at a time: a row
    end comes first where it is <= the nonzero index."""
    n = len(row_offsets) - 1
    total = n + nnz
    diags = [min(t * tile, total) for t in range(-(-total // tile) + 1)]
    coords, row, nz = [], 0, 0
    for item in range(total + 1):
        while diags and diags[0] == item:
            coords.append((row, nz))
            diags.pop(0)
        if item == total:
            break
        if row < n and row_offsets[row + 1] <= nz:
            row += 1
        else:
            nz += 1
    return np.array(coords, dtype=np.int32).reshape(-1, 2)


@pytest.mark.parametrize("tile", [5, 64, TILE])
@pytest.mark.parametrize("name", list(CASES))
def test_tile_coords_equal_a_merge_path_walk(name, tile):
    csr = CASES[name]()
    ro = np.asarray(csr.row_offsets)
    got = merge_spmv.merge_tile_coords(ro, csr.nnz, tile)
    assert got.dtype == np.int32
    assert got.shape == (-(-(csr.num_rows + csr.nnz) // tile) + 1, 2)
    np.testing.assert_array_equal(got, _walk(ro, csr.nnz, tile))
    assert tuple(got[-1]) == (csr.num_rows, csr.nnz)


def test_wheel_hub_spans_several_tiles():
    csr = CASES["wheel-5000"]()
    coords = merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz)
    # the hub (row 0, 5000 nonzeros) is still open where >= 3 tiles start
    assert int(np.sum(coords[:, 0] == 0)) >= 3


def _emulate(csr, x, coords):
    """y of K2's tile decomposition in float64: each tile walks its
    items from its start, writing every row it completes; its last
    partial is its carry-out, and the first tile of each run of
    carry-outs on one row adds the run, in tile order, into y."""
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices)
    va = np.asarray(csr.values, dtype=np.float64)
    n = csr.num_rows
    y = np.zeros(n)
    carry_rows, carry_vals = [], []
    for (row, nz), (erow, enz) in zip(coords[:-1], coords[1:]):
        assert 0 < (erow - row) + (enz - nz) <= TILE
        running = 0.0
        for _ in range((erow - row) + (enz - nz)):
            if row < n and ro[row + 1] <= nz:
                y[row] = running
                running = 0.0
                row += 1
            else:
                running += va[nz] * x[ci[nz]]
                nz += 1
        assert (row, nz) == (erow, enz)
        carry_rows.append(int(erow))
        carry_vals.append(running)
    for c, r in enumerate(carry_rows):
        if r >= n or (c > 0 and carry_rows[c - 1] == r):
            continue
        s, k = carry_vals[c], c + 1
        while k < len(carry_rows) and carry_rows[k] == r:
            s += carry_vals[k]
            k += 1
        y[r] += s
    return y


@pytest.mark.parametrize("name", list(CASES))
def test_tiles_cover_every_item_once(name):
    """Integer values and x make every sum exact: the emulated tiles
    equal the row sums only if each nonzero is added once, into its
    row."""
    csr = CASES[name]()
    rng = np.random.default_rng(6)
    csr = CsrMatrix(csr.num_rows, csr.num_cols, csr.row_offsets,
                    csr.col_indices,
                    rng.integers(-4, 5, csr.nnz).astype(np.float64))
    x = rng.integers(-4, 5, csr.num_cols).astype(np.float64)
    coords = merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz)
    y = _emulate(csr, x, coords)
    np.testing.assert_array_equal(y, csr.to_scipy() @ x)


def test_every_merge_plan_carries_its_tiles():
    """The port's own plan, a carried JAX plan, a hybrid's remainder and
    a reordered plan's inner plan all hold merge_tile_coords of their
    CSR."""
    j = jgen.make_rmat(9).to_csr()
    host = CsrMatrix(j.num_rows, j.num_cols, np.asarray(j.row_offsets),
                     np.asarray(j.col_indices), np.asarray(j.values))
    own = plan_matrix(host, "merge", device="cpu", dtype=np.float32)
    carried = plan_from_arrays("csr", {
        "row_offsets": np.asarray(j.row_offsets),
        "col_indices": np.asarray(j.col_indices),
        "values": np.asarray(j.values), "shape": j.shape}, "cpu")
    want = merge_spmv.merge_tile_coords(host.row_offsets, host.nnz)
    for P in (own, carried):
        assert P.tile_coords.dtype == torch.int32
        np.testing.assert_array_equal(P.tile_coords.numpy(), want)
    wheel = gen.make_wheel(3000).to_csr()
    H = plan_matrix(wheel, "auto", device="cpu", dtype=np.float32)
    assert isinstance(H, HybridPlan) and H.rest is not None
    np.testing.assert_array_equal(
        H.rest.tile_coords.numpy(),
        merge_spmv.merge_tile_coords(H.rest.row_offsets.numpy(),
                                     H.rest.nnz))
    R = plan_matrix(host, "merge", reorder="rcm", device="cpu",
                    dtype=np.float32)
    assert isinstance(R, ReorderedPlan)
    np.testing.assert_array_equal(
        R.inner.tile_coords.numpy(),
        merge_spmv.merge_tile_coords(R.inner.row_offsets.numpy(),
                                     R.inner.nnz))


def _recording(monkeypatch, module, name):
    """Wrap ``module.name`` (a kernel entry as the dispatch layer calls
    it) so that the tensors it returns are kept."""
    out = []
    fn = getattr(module, name)

    def wrapped(*args):
        out.append(fn(*args))
        return out[-1]

    monkeypatch.setattr(module, name, wrapped)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_alpha_one_returns_the_kernel_output(monkeypatch, dtype):
    """spmv and spmm at alpha = 1 give back the kernel wrapper's own
    tensor (no elementwise pass); other alpha and beta are computed as
    before, alpha * y + beta * y0."""
    csr = gen.make_rmat(8).to_csr()
    rng = np.random.default_rng(7)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    x = torch.from_numpy(rng.standard_normal(csr.num_cols)).to(tdt)
    X = torch.from_numpy(rng.standard_normal((csr.num_cols, 3))).to(tdt)
    y0 = torch.from_numpy(rng.standard_normal(csr.num_rows)).to(tdt)
    Y0 = torch.from_numpy(rng.standard_normal((csr.num_rows, 3))).to(tdt)
    M = plan_matrix(csr, "merge", dtype=dtype, device="cpu")
    S = plan_matrix(csr, "row_split", dtype=dtype, device="cpu")

    seen = _recording(monkeypatch, dispatch, "merge_matvec")
    y = spmv(M, x)
    assert y is seen[-1]
    assert torch.equal(y, merge_spmv.spmv_merge_plain(M, x))
    assert torch.equal(spmv(M, x, alpha=2.0, beta=-0.5, y=y0),
                       2.0 * y - 0.5 * y0)
    assert torch.equal(spmv(M, x, alpha=-3.0), -3.0 * y)

    for plan, name in ((M, "merge_matmat"), (S, "row_split_matmat")):
        seen = _recording(monkeypatch, dispatch, name)
        Y = spmm(plan, X)
        assert Y is seen[-1]
        y1 = spmm(plan, x)
        assert y1.shape == (csr.num_rows,)
        assert torch.equal(y1, seen[-1][:, 0])
        assert torch.equal(spmm(plan, X, alpha=2.0, beta=-0.5, Y=Y0),
                           2.0 * Y - 0.5 * Y0)
        assert torch.equal(spmm(plan, X, alpha=0.5), 0.5 * Y)
