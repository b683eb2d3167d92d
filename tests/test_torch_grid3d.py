"""The benchmark's ``--grid3d`` 7-point configuration
(``benchmark/matrices/grid3d7.py``) against the port and the JAX package.

The benchmark's generator gives the port's ``make_laplacian_grid3d``
CSR and JAX's ``make_grid3d(self_loop=True)`` pattern; its stencil
reference is what ``spmm`` on the AUTO plan (the masked band: K1's
plain version on the CPU at L = 1, K7's, which gives K1's bits, on a
row-major block) computes on (n, L) blocks, within K1's bound: with
u = 2^-24,

    |Y - Y_ref|_il <= 2 K u (|A| |X|)_il,  K = 7 diagonals.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse.io import generators as jgen
from tpusparse_torch import CsrMatrix, plan_kind, plan_matrix, spmm
from tpusparse_torch.io import generators as gen

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark/configs/grid3d-7pt-160.json").read_text())
U = 2.0 ** -24


def _load(path: Path):
    spec = importlib.util.spec_from_file_location("bench_grid3d7", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


grid3d7 = _load(ROOT / "benchmark/matrices/grid3d7.py")

# (nx, ny, nz): an odd box, and cubes
GRIDS = [(7, 5, 4), (6, 6, 6), (5, 5, 5)]


def _generated(dims):
    nx, ny, nz = dims
    cfg = dict(CFG, nx=nx, ny=ny, nz=nz)
    return cfg, grid3d7.generate(cfg, None, "cpu")


def _csr(p) -> CsrMatrix:
    return CsrMatrix(p["num_rows"], p["num_cols"], p["row_offsets"],
                     p["col_indices"], p["values"])


@pytest.mark.parametrize("dims", GRIDS, ids=lambda d: "x".join(map(str, d)))
def test_generator_is_the_ports_laplacian_and_jaxs_pattern(dims):
    nx, ny, nz = dims
    _, p = _generated(dims)
    shape = (nz, ny, nx)          # x fastest, as both generators order it
    if nx == ny == nz:
        port = gen.make_laplacian_grid3d(nx, dtype=np.float32).to_csr()
        jax = jgen.make_grid3d(nx, self_loop=True).to_csr()
    else:
        port = gen._laplacian(shape, 6.0, np.float32).to_csr()
        jax = jgen._grid_neighbors(shape, True, 1.0, np.float64).to_csr()
    assert p["row_offsets"].dtype == np.int32
    assert p["col_indices"].dtype == np.int32
    assert p["values"].dtype == np.float32
    np.testing.assert_array_equal(p["row_offsets"], port.row_offsets)
    np.testing.assert_array_equal(p["col_indices"], port.col_indices)
    np.testing.assert_array_equal(p["values"], port.values)
    np.testing.assert_array_equal(p["row_offsets"],
                                  np.asarray(jax.row_offsets))
    np.testing.assert_array_equal(p["col_indices"],
                                  np.asarray(jax.col_indices))
    n = nx * ny * nz
    assert p["col_indices"].shape[0] == 7 * n - 2 * (nx * ny + ny * nz
                                                     + nx * nz)


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("dims", GRIDS[:2],
                         ids=lambda d: "x".join(map(str, d)))
def test_auto_spmm_on_row_major_blocks_is_the_stencil(dims, L):
    cfg, p = _generated(dims)
    n = p["num_rows"]
    plan = plan_matrix(_csr(p), dtype=np.float32, L=L, device="cpu")
    assert plan_kind(plan) == "dia"
    g = torch.Generator().manual_seed(1000 + L)
    X = torch.randn((n, L), generator=g, dtype=torch.float32)
    Y = spmm(plan, X)
    assert Y.shape == (n, L) and Y.dtype == torch.float32
    X64 = X.double()
    ref = grid3d7.reference_matmat(cfg, p, X64)
    bound = 2 * 7 * U * grid3d7.reference_matmat(cfg, p, X64, absolute=True)
    err = (Y.double() - ref).abs()
    assert torch.all(err <= bound), float((err - bound).max())
