"""Synthetic matrix generators — the built-in benchmark fixtures.

Port of ``tpusparse/io/generators.py`` for the fixtures the main path
uses. Each gives the same arrays for the same arguments and seed as the
JAX package, so both packages can be handed one matrix.

  * ``make_laplacian_grid2d/3d`` — SPD 5/7-point Laplacians (the
    headline fixture is ``make_laplacian_grid3d(48)``);
  * ``make_wheel`` — hub-and-rim wheel: one row holds ``spokes``
    nonzeros (the row-skew stress test for merge-path SpMV);
  * ``make_rmat`` / ``make_rmat_spd`` — R-MAT power-law graphs;
  * ``make_variable_stencil`` — variable-coefficient SPD diffusion;
  * ``make_fem2d`` — P1 finite elements on a random Delaunay mesh;
  * ``make_block_random`` — block-sparse random tiles (the BCSR
    fixture).
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.formats.coo import CooMatrix


def make_wheel(spokes: int, default_value: float = 1.0,
               dtype=np.float64) -> CooMatrix:
    """Wheel graph: hub row 0 with ``spokes`` nonzeros plus the rim
    cycle."""
    i = np.arange(spokes, dtype=np.int32)
    rows = np.concatenate([np.zeros(spokes, dtype=np.int32), i + 1])
    cols = np.concatenate([i + 1, ((i + 1) % spokes) + 1])
    vals = np.full(2 * spokes, default_value, dtype=dtype)
    return CooMatrix(spokes + 1, spokes + 1, rows, cols, vals)


def _strides(shape_dims) -> np.ndarray:
    nd = len(shape_dims)
    strides = np.ones(nd, dtype=np.int64)
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * shape_dims[d + 1]
    return strides


def _grid_neighbors(shape_dims, self_loop, default_value, dtype):
    """Stencil on a dense grid: one nonzero per (node, axis-neighbour)
    pair, optional self loop."""
    nd = len(shape_dims)
    n = int(np.prod(shape_dims))
    coords = np.stack(np.unravel_index(np.arange(n), shape_dims), axis=0)
    strides = _strides(shape_dims)
    me = np.arange(n, dtype=np.int64)
    rows_l, cols_l = [], []
    for d in range(nd):
        for delta in (-1, +1):
            ok = (coords[d] + delta >= 0) & (coords[d] + delta < shape_dims[d])
            rows_l.append(me[ok])
            cols_l.append(me[ok] + delta * strides[d])
    if self_loop:
        rows_l.append(me)
        cols_l.append(me)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.full(rows.size, default_value, dtype=dtype)
    idt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idt), cols.astype(idt), vals)


def _laplacian(shape_dims, diag: float, dtype) -> CooMatrix:
    g = _grid_neighbors(shape_dims, False, -1.0, dtype)
    n = g.num_rows
    rows = np.concatenate([g.rows, np.arange(n, dtype=g.rows.dtype)])
    cols = np.concatenate([g.cols, np.arange(n, dtype=g.cols.dtype)])
    vals = np.concatenate([g.vals, np.full(n, diag, dtype=dtype)])
    return CooMatrix(n, n, rows, cols, vals)


def make_laplacian_grid2d(width: int, dtype=np.float64) -> CooMatrix:
    """SPD 5-point Laplacian: 4 on the diagonal, -1 on neighbours."""
    return _laplacian((width, width), 4.0, dtype)


def make_laplacian_grid3d(width: int, dtype=np.float64) -> CooMatrix:
    """SPD 7-point Laplacian: 6 on the diagonal, -1 on neighbours."""
    return _laplacian((width, width, width), 6.0, dtype)


def make_variable_stencil(width: int, dims: int = 3, full: bool = False,
                          seed: int = 0, sigma: float = 1.0,
                          shift: float = 1e-2,
                          dtype=np.float64) -> CooMatrix:
    """Variable-coefficient SPD diffusion stencil ``div(c grad u)`` on a
    ``dims``-D grid with lognormal edge conductivities
    ``c = exp(sigma * N(0, 1))``, plus ``shift`` on the diagonal.
    ``full`` takes all ``3^dims - 1`` neighbours instead of the axis
    neighbours. Every diagonal carries per-row values, so it is not
    maskable."""
    nd = int(dims)
    n = int(width) ** nd
    shape_dims = (width,) * nd
    rng = np.random.default_rng(seed)
    coords = np.stack(np.unravel_index(np.arange(n), shape_dims), axis=0)
    strides = _strides(shape_dims)
    me = np.arange(n, dtype=np.int64)
    if full:
        deltas = [tuple(x - 1 for x in raw)
                  for raw in np.ndindex(*(3,) * nd)
                  if tuple(x - 1 for x in raw) > (0,) * nd]
    else:
        deltas = [tuple(1 if k == d else 0 for k in range(nd))
                  for d in range(nd)]
    rows_l, cols_l, vals_l = [], [], []
    diag = np.full(n, float(shift), dtype=np.float64)
    for dl in deltas:
        ok = np.ones(n, dtype=bool)
        for d, dd in enumerate(dl):
            if dd:
                ok &= (coords[d] + dd >= 0) & (coords[d] + dd < width)
        i = me[ok]
        j = i + int(np.dot(dl, strides))
        c = np.exp(sigma * rng.standard_normal(i.size))
        rows_l += [i, j]
        cols_l += [j, i]
        vals_l += [-c, -c]
        np.add.at(diag, i, c)
        np.add.at(diag, j, c)
    rows = np.concatenate(rows_l + [me])
    cols = np.concatenate(cols_l + [me])
    vals = np.concatenate([v.astype(dtype) for v in vals_l]
                          + [diag.astype(dtype)])
    idt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idt), cols.astype(idt), vals)


def make_rmat(scale: int, edge_factor: int = 16, a: float = 0.57,
              b: float = 0.19, c: float = 0.19, seed: int = 0,
              symmetric: bool = True, dtype=np.float64) -> CooMatrix:
    """R-MAT (Graph500 Kronecker) power-law graph: 2^scale vertices,
    ``edge_factor * 2^scale`` edges by recursive quadrant probabilities
    (a, b, c, d). Duplicate edges are kept (CSR semantics sum them);
    ``symmetric`` mirrors every edge."""
    n = 1 << scale
    ne = edge_factor * n
    rng = np.random.default_rng(seed)
    rows = np.zeros(ne, dtype=np.int64)
    cols = np.zeros(ne, dtype=np.int64)
    for lvl in range(scale):
        u = rng.random(ne)
        hi_r = u >= a + b
        hi_c = (u >= a) & (u < a + b) | (u >= a + b + c)
        rows |= hi_r.astype(np.int64) << lvl
        cols |= hi_c.astype(np.int64) << lvl
    vals = rng.standard_normal(ne).astype(dtype)
    if symmetric:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
        vals = np.concatenate([vals, vals])
    idt = np.int32 if n <= np.iinfo(np.int32).max else np.int64
    return CooMatrix(n, n, rows.astype(idt), cols.astype(idt), vals)


def make_rmat_spd(scale: int, edge_factor: int = 8, seed: int = 0,
                  dtype=np.float64) -> CooMatrix:
    """SPD power-law fixture: symmetric R-MAT made a diagonally dominant
    graph Laplacian (off-diagonals ``-|v|``, diagonal ``sum + 1``)."""
    import scipy.sparse as sp

    g = make_rmat(scale, edge_factor, seed=seed, symmetric=True,
                  dtype=np.float64)
    S = sp.coo_matrix((np.abs(g.vals), (g.rows, g.cols)),
                      shape=g.shape).tocsr()
    S.sum_duplicates()
    S.setdiag(0)
    S.eliminate_zeros()
    d = np.asarray(S.sum(axis=1)).ravel() + 1.0
    A = (-S + sp.diags(d)).tocoo()
    return CooMatrix(g.num_rows, g.num_cols, A.row.astype(np.int32),
                     A.col.astype(np.int32), A.data.astype(dtype))


def make_fem2d(n_points: int, seed: int = 0, lump: float = 1e-3,
               dtype=np.float64) -> CooMatrix:
    """P1 finite-element stiffness matrix on a random Delaunay
    triangulation of the unit square (the SuiteSparse structural / FEM
    class): irregular node numbering and bandwidth, ~7 nonzeros a row,
    SPD through a lumped-mass diagonal shift ``lump * area / 3`` per
    incident triangle (the discrete Helmholtz operator)."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    tri = Delaunay(pts).simplices
    p = pts[tri]
    e = p[:, [2, 0, 1]] - p[:, [1, 2, 0]]
    area = 0.5 * np.abs(e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0])
    k = np.einsum("tix,tjx->tij", e, e) / (4.0 * area)[:, None, None]
    rows = np.concatenate([np.repeat(tri, 3, axis=1).ravel(), tri.ravel()])
    cols = np.concatenate([np.tile(tri, (1, 3)).ravel(), tri.ravel()])
    vals = np.concatenate([k.ravel(), lump * np.repeat(area / 3.0, 3)])
    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(n_points, n_points)).tocsr().tocoo()
    return CooMatrix(n_points, n_points, A.row.astype(np.int32),
                     A.col.astype(np.int32), A.data.astype(dtype))


def make_block_random(block_grid: int, blocks_per_row: int = 4,
                      block_rows: int = 8, block_cols: int = 128,
                      fill: float = 1.0, seed: int = 0,
                      dtype=np.float64) -> CooMatrix:
    """Block-sparse random matrix of (block_grid * block_rows) x
    (block_grid * block_cols): ``blocks_per_row`` tiles per block row
    (one always on the block diagonal, the rest at random block columns),
    each filled to ``fill`` density — the multi-DOF FEM pattern the
    reference's BcsrMatrix targets."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    per_tile = block_rows * block_cols
    k = max(int(per_tile * fill), 1)
    for br in range(block_grid):
        bcs = set([br % block_grid])
        while len(bcs) < min(blocks_per_row, block_grid):
            bcs.add(int(rng.integers(0, block_grid)))
        for bc in bcs:
            if fill >= 1.0:
                lr = np.repeat(np.arange(block_rows), block_cols)
                lc = np.tile(np.arange(block_cols), block_rows)
            else:
                flat = rng.choice(per_tile, size=k, replace=False)
                lr, lc = flat // block_cols, flat % block_cols
            rows_l.append(br * block_rows + lr)
            cols_l.append(bc * block_cols + lc)
    rows = np.concatenate(rows_l).astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(dtype)
    return CooMatrix(block_grid * block_rows, block_grid * block_cols,
                     rows, cols, vals).sum_duplicates()
