"""Masked DIA (kernel K1's plain version) against the JAX package.

The JAX AUTO plan's masked operand (``mask_b``, offsets, vals) is
carried into the port (``utils/carry.py``), so both packages run on the
same operand; Pallas runs in interpret mode on the CPU. Each side is
within gamma_K of the exact sum, so with u = 2^-24:

    |y_port - y_jax|_i <= 2 K u (|A| |x|)_i.

The port's own mask words must equal the JAX plan's exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.formats.coo import CooMatrix as JCoo
from tpusparse.io import generators as jgen
from tpusparse.kernels.dia_stream import spmm_dia_stream_t as jspmm_t
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse_torch import plan_matrix, spmv
from tpusparse_torch.formats.coo import CooMatrix
from tpusparse_torch.formats.dia import partition_dia, select_diagonals
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import dia_stream
from tpusparse_torch.utils.carry import plan_from_arrays

U = 2.0 ** -24


def _band32(pkg_coo):
    """Constant-coefficient band with 32 diagonals (-16..15), so bit 31
    of the mask is used."""
    n = 300
    coef = np.random.default_rng(7).uniform(-2.0, 2.0, 32)
    rows, cols, vals = [], [], []
    for k, off in enumerate(range(-16, 16)):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(np.full(i.size, coef[k]))
    return pkg_coo(n, n, np.concatenate(rows).astype(np.int32),
                   np.concatenate(cols).astype(np.int32),
                   np.concatenate(vals))


FIXTURES = {
    "lap3d-12": (lambda: jgen.make_laplacian_grid3d(12),
                 lambda: gen.make_laplacian_grid3d(12)),
    "lap2d-16": (lambda: jgen.make_laplacian_grid2d(16),
                 lambda: gen.make_laplacian_grid2d(16)),
    "band-32": (lambda: _band32(JCoo), lambda: _band32(CooMatrix)),
}


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(JAX f32 AUTO plan's masked operand, host CSR as f32 scipy)."""
    csr = FIXTURES[name][0]().to_csr()
    P = jplan(csr, "auto", dtype=np.float32)
    assert P.rest is None and P.dia.mask_b is not None
    return P.dia, csr.astype(np.float32).to_scipy().astype(np.float64)


def _carried(Dj):
    return plan_from_arrays("dia_masked", {
        "mask_b": np.asarray(Dj.mask_b), "offsets": Dj.offsets,
        "vals": Dj.vals, "shape": (Dj.num_rows, Dj.num_cols)}, "cpu")


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_k1_plain_matches_jax_on_same_operand(name, L):
    Dj, A64 = _jax_side(name)
    D = _carried(Dj)
    n = Dj.num_rows
    XT = np.random.default_rng(L).standard_normal((L, n)).astype(np.float32)
    Yj = np.asarray(jspmm_t(Dj, jnp.asarray(XT)))
    Y = dia_stream.spmm_dia_stream_t(D, torch.from_numpy(XT)).numpy()
    assert Y.shape == Yj.shape == (L, n) and Y.dtype == np.float32
    AX = (abs(A64) @ np.abs(XT).T.astype(np.float64)).T
    bound = 2 * len(D.offsets) * U * AX
    assert np.all(np.abs(Y.astype(np.float64) - Yj) <= bound)
    # and each side against the float64 product, within K u
    exact = (A64 @ XT.T.astype(np.float64)).T
    assert np.all(np.abs(Y - exact) <= len(D.offsets) * U * AX * 1.01)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_mask_words_equal_jax_plan(name):
    Dj, _ = _jax_side(name)
    n = Dj.num_rows
    jwords = np.asarray(Dj.mask_b).reshape(-1)[:n].view(np.uint32)
    csr = FIXTURES[name][1]().to_csr()
    host, rest = partition_dia(csr, select_diagonals(csr))
    assert rest.nnz == 0
    np.testing.assert_array_equal(dia_stream.mask_words(host), jwords)
    A = plan_matrix(csr, "auto", device="cpu")
    assert A.dia.offsets == tuple(Dj.offsets)
    np.testing.assert_array_equal(A.dia.mask.numpy().view(np.uint32), jwords)
    np.testing.assert_array_equal(A.dia.vals.numpy(),
                                  np.asarray(Dj.vals, dtype=np.float32))
    assert A.dia.vals_host == tuple(float(v) for v in Dj.vals)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_own_plan_equals_carried_plan(name):
    Dj, _ = _jax_side(name)
    csr = FIXTURES[name][1]().to_csr()
    A = plan_matrix(csr, "auto", device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        csr.num_cols).astype(np.float32))
    y_carried = dia_stream.spmv_dia_stream(_carried(Dj), x)
    np.testing.assert_array_equal(spmv(A, x).numpy(), y_carried.numpy())


def test_bit31_is_used_and_read():
    csr = _band32(CooMatrix).to_csr()
    A = plan_matrix(csr, "auto", device="cpu")
    words = A.dia.mask.numpy().view(np.uint32)
    assert len(A.dia.offsets) == 32 and np.any(words >> 31)
    x = torch.zeros(csr.num_cols)
    x[-1] = 1.0   # column n-1 reaches row n-16 through offset +15 (bit 31)
    y = spmv(A, x).numpy()
    assert y[csr.num_rows - 16] == np.float32(A.dia.vals_host[31])


def test_out_of_range_neighbours_read_zero():
    csr = gen.make_laplacian_grid2d(4).to_csr()   # offsets -4 -1 0 1 4
    A = plan_matrix(csr, "auto", device="cpu")
    y = spmv(A, torch.ones(csr.num_cols))
    np.testing.assert_array_equal(y.numpy(), csr.to_scipy() @ np.ones(16))
    # x[4] = inf: row 3 reaches column 4 through offset +1 with a zero
    # coefficient (grid-row wrap); the load is in range, so 0 * inf = nan
    # as in the TPU kernel. Row 0 reads x[-4] as 0 and x[4] as -1 * inf.
    x = torch.zeros(csr.num_cols)
    x[4] = float("inf")
    y = spmv(A, x).numpy()
    assert np.isnan(y[3]) and y[0] == -np.inf and y[1] == 0 and y[2] == 0


def test_alpha_beta():
    csr = gen.make_laplacian_grid2d(5).to_csr()
    A = plan_matrix(csr, "auto", device="cpu")
    x = torch.linspace(-1, 1, csr.num_cols)
    y0 = torch.ones(csr.num_rows)
    np.testing.assert_allclose(
        spmv(A, x, alpha=2.0, beta=0.5, y=y0).numpy(),
        2.0 * spmv(A, x).numpy() + 0.5, rtol=1e-6)


def test_wrapper_rejects_bad_operands():
    csr = gen.make_laplacian_grid2d(4).to_csr()
    D = plan_matrix(csr, "auto", device="cpu").dia
    # mixed types: float64 XT on a float32 operand
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_stream_t(D, torch.zeros(1, 16,
                                                    dtype=torch.float64))
    with pytest.raises(ValueError):
        dia_stream.spmm_dia_stream_t(D, torch.zeros(1, 15))
    with pytest.raises(ValueError):
        dia_stream.spmm_dia_stream_t(D, torch.zeros(16, 2).t())
    with pytest.raises(ValueError):
        dia_stream.spmm_dia_stream_t(D, torch.zeros(1, 16, device="meta"))
    Dm = dia_stream.from_mask_words(16, 16, D.offsets, D.vals.numpy(),
                                    D.mask.numpy(), "meta")
    with pytest.raises(ValueError, match="no K1 path"):
        dia_stream.spmm_dia_stream_t(Dm, torch.zeros(1, 16, device="meta"))
    with pytest.raises(ValueError, match="square"):
        dia_stream.from_mask_words(16, 17, D.offsets, D.vals.numpy(),
                                   D.mask.numpy(), "cpu")


def test_carry_rejects_unknown_kind_and_dirty_pad():
    Dj, _ = _jax_side("lap2d-16")
    arrays = {"mask_b": np.asarray(Dj.mask_b).copy(), "offsets": Dj.offsets,
              "vals": Dj.vals, "shape": (Dj.num_rows, Dj.num_cols)}
    with pytest.raises(ValueError, match="unknown plan kind"):
        plan_from_arrays("bsr", arrays, "cpu")
    arrays["mask_b"].reshape(-1)[-1] = 1
    with pytest.raises(ValueError, match="zero pad"):
        plan_from_arrays("dia_masked", arrays, "cpu")
