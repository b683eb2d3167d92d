"""K3's decomposition of the merge path (``csrc/merge_spmm.cu``) on the
plan's tiles, emulated on the CPU, and the checks its wrapper makes.

K3 reads the tile starts the plan holds for K2 (``MergeDevice.
tile_coords``). Inside a tile the CTA's threads form lane groups; each
group walks one stretch of ``spmm_merge.group_items`` merge items,
keeps its first completed row for a head that the earlier groups'
partials supply (in group order), and the CTA's last partial is its
carry-out, which the fix-up adds into its row in tile order. A float64
emulation of that decomposition gives the exact row sums of
integer-valued matrices at several L on edge cases (num_rows = 0,
nnz = 0, empty rows, the rectangular ``bibd_9_3``, a wheel hub spanning
several tiles, rmat-10), so every merge item is taken once, into its
row. The emulation imports no JAX: the card tests
(``test_torch_cuda.py``) hold K3's Y to it.

The wrapper refuses a plan without tile starts, with the starts of
another tile size, or a library whose tile or group geometry differs
from the Python mirror, before anything is launched (the stand-in
library is ``test_torch_layers.py``'s).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse_torch import CsrMatrix
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.kernels import merge_spmv, spmm_merge
from test_torch_layers import stand_in  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parent.parent
TILE = merge_spmv.TILE_ITEMS
LS = (1, 3, 16, 33)

K3_CASES = {
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


def integer_valued(csr, L, seed):
    """(csr with values in -4 .. 4, X (num_cols, L) in -4 .. 4), both
    float64: every sum of K3's is exact in float64, and in float32 while
    |partials| < 2^24."""
    rng = np.random.default_rng(seed)
    A = CsrMatrix(csr.num_rows, csr.num_cols, csr.row_offsets,
                  csr.col_indices,
                  rng.integers(-4, 5, csr.nnz).astype(np.float64))
    return A, rng.integers(-4, 5, (csr.num_cols, L)).astype(np.float64)


def emulate_k3(csr, X, coords):
    """Y of K3's decomposition on the tiles ``coords``, in X's type
    (numpy rounds each product and sum apart, as the kernel does): each
    tile's lane groups walk their stretches of ``group_items`` items
    in path order, writing every row they complete but their first;
    a group's first completed row gets the head, the sum in group order
    of the end partials of the groups before it back to the last one
    that completed a row; the CTA's carry-out (the same sum over all its
    groups) belongs to the row of the next tile start, and the first
    tile of each run of carry-outs on one row adds the run, in tile
    order, into that row. In float64 it is K3d's Y bit for bit, in
    float32 K3's."""
    ro = np.asarray(csr.row_offsets)
    ci = np.asarray(csr.col_indices)
    va = np.asarray(csr.values, dtype=X.dtype)
    n, L = csr.num_rows, X.shape[1]
    per = spmm_merge.group_items(L, X.dtype.itemsize)
    groups = TILE // per
    Y = np.zeros((n, L), X.dtype)
    carry = []

    def partial(runs, done, hi):
        k = hi - 1
        while k > 0 and not done[k]:
            k -= 1
        s = np.zeros(L, X.dtype)
        for j in range(max(k, 0), hi):
            s = s + runs[j]
        return s

    for (row, nz), (erow, enz) in zip(coords[:-1], coords[1:]):
        items = (erow - row) + (enz - nz)
        assert 0 < items <= TILE
        runs, done = [], []
        for g in range(groups):
            d0 = min(g * per, items)
            running, first = np.zeros(L, X.dtype), None
            for _ in range(min(d0 + per, items) - d0):
                if row < n and ro[row + 1] <= nz:
                    if first is None:
                        first = (row, running)
                    else:
                        Y[row] = running
                    running = np.zeros(L, X.dtype)
                    row += 1
                else:
                    running = running + va[nz] * X[ci[nz]]
                    nz += 1
            runs.append(running)
            done.append(first is not None)
            if first is not None:
                Y[first[0]] = partial(runs, done, g) + first[1]
        assert (row, nz) == (erow, enz)
        carry.append(partial(runs, done, groups))
    rows = coords[1:, 0]
    for c, r in enumerate(rows):
        if r >= n or (c > 0 and rows[c - 1] == r):
            continue
        s, k = carry[c], c + 1
        while k < len(rows) and rows[k] == r:
            s = s + carry[k]
            k += 1
        Y[r] = Y[r] + s
    return Y


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_tiles_give_exact_row_sums(name, L):
    """Integer values and X make every sum exact: the emulated
    decomposition equals the row sums, and the plain version, only if
    each nonzero is added once, into its row."""
    A, X = integer_valued(K3_CASES[name](), L, 11 + L)
    coords = merge_spmv.merge_tile_coords(A.row_offsets, A.nnz)
    Y = emulate_k3(A, X, coords)
    assert Y.shape == (A.num_rows, L)
    np.testing.assert_array_equal(Y, A.to_scipy() @ X)
    M = merge_spmv.to_device_merge(A, "cpu", torch.float64)
    np.testing.assert_array_equal(
        Y, spmm_merge.spmm_merge_plain(M, torch.from_numpy(X)).numpy())


def test_wheel_hub_spans_several_tiles_and_groups():
    """The wheel's hub (row 0, 5000 nonzeros) is open across several
    tiles: the first tile holds nothing but hub nonzeros, so none of its
    groups completes a row, at any L."""
    csr = K3_CASES["wheel-5000"]()
    coords = merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz)
    assert int(np.sum(coords[1:, 0] == 0)) >= 3
    assert tuple(coords[1]) == (0, TILE)


def _constants(path, names):
    src = (ROOT / "tpusparse_torch" / "csrc" / path).read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
            for k in names}


def test_group_geometry_mirrors_the_source():
    """``group_items`` is built from the constants of csrc/merge_spmm.cu
    (threads per CTA, tile, largest group, bytes of lanes a thread) and
    K2's tile, which K3 works on; it is what every launch checks against
    the library."""
    k3 = _constants("merge_spmm.cu",
                    ("kBlock", "kTileItems", "kMaxGroup", "kLaneBytes"))
    k2 = _constants("merge_spmv.cu", ("kThreads", "kItems"))
    assert k3["kTileItems"] == TILE == k2["kThreads"] * k2["kItems"]
    assert k3["kBlock"] == spmm_merge.BLOCK_THREADS
    assert k3["kMaxGroup"] == spmm_merge.MAX_GROUP
    assert k3["kLaneBytes"] == spmm_merge.LANE_BYTES
    for itemsize in (4, 8):
        wide = k3["kLaneBytes"] // itemsize
        for L in (1, 2, 3, 4, 6, 16, 17, 32, 33, 100):
            v = spmm_merge.lanes_per_thread(L, itemsize)
            assert v == (wide if L % wide == 0 else 1)
            w = min(1 << (-(-L // v) - 1).bit_length(), k3["kMaxGroup"])
            assert spmm_merge.group_items(L, itemsize) == \
                TILE * w // k3["kBlock"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_launch_refuses_a_plan_without_its_tiles(stand_in, dtype):
    """K3's launch (the CUDA path of ``merge_matmat``) needs the plan's
    tile starts for K2's tile: without them, with another tile size's or
    of the wrong type it raises before launching anything; so does a
    library whose tile or group stretch differs from the mirror."""
    csr = gen.make_rmat(10).to_csr()
    M = merge_spmv.to_device_merge(csr, "cpu", dtype)
    X = torch.zeros((M.num_cols, 16), dtype=dtype)
    other = merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz, 2 * TILE)
    stand_in()
    for coords in (None, torch.from_numpy(other), M.tile_coords.long(),
                   M.tile_coords[:-1]):
        with pytest.raises(ValueError, match="tile_coords"):
            spmm_merge._launch(dataclasses.replace(M, tile_coords=coords), X)
    stand_in(tile=2 * TILE)
    with pytest.raises(RuntimeError, match="tile"):
        spmm_merge._launch(M, X)
    stand_in(group_skew=8)
    with pytest.raises(RuntimeError, match="group_items"):
        spmm_merge._launch(M, X)
