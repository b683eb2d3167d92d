"""The port's float64 path against the JAX package.

The port's float64 is strict IEEE float64 (``plan_semantics`` 'ieee-f64'),
so it is held to the JAX package's IEEE float64 paths: the XLA float64
DIA op (``formats.dia.to_device_dia(dtype=float64)`` with ``ops/dia.py``)
and the ``strategy='reference'`` float64 plan. The JAX double-float
(two-f32) kernels that the port's float64 kernels replace run as a second
comparison, in interpret mode on the CPU as the JAX package's own tests
run them, at their own ~1e-14 accuracy: B11 (masked DIA), B10 (value
planes), B7 (merge SpMV), B8 (merge SpMM) and B9 (row-split SpMM).

Both packages get the same host CSR (the port's generators and reader;
``test_torch_host.py`` checks they give the JAX package's arrays), and
the inputs come from numpy seeds. With u = 2^-53:

  * K1d and K5d plain versions against the XLA float64 DIA op, entry by
    entry: ``|y - y_jax| <= 2 K u (|A||x|)`` (each side is within K u);
  * K2d, K3d and K4d plain versions against the float64 golden
    ``spmv_numpy`` (or the float64 scipy product), entry by entry:
    ``(nnz_i + 2) u (|A||x|)_i``;
  * everything against the JAX reference plan and the double-float
    kernels normwise: ``max|y - y_jax| <= 1e-13 max(|A||x|)``.

The double-float kernels cost seconds to compile in interpret mode, so
each runs on one or two fixtures; B8's lanes are independent, so it runs
once at L = 16 and the port's product at L < 16 is held to its first L
columns.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.formats import dia as jdia
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.kernels import dia_stream as jds
from tpusparse.ops import dia as jops_dia
from tpusparse.ops.spmv import plan_kind as jplan_kind
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import plan_semantics as jplan_semantics
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse.solvers.cg import cg_solve as jcg_solve
from tpusparse.solvers.cg import cg_solve_multi as jcg_solve_multi
from tpusparse.solvers.refine import cg_solve_multi_refined as jmulti_refined
from tpusparse.solvers.refine import cg_solve_refined as jrefined
from tpusparse_torch import (
    CsrMatrix,
    cg_solve,
    cg_solve_multi,
    cg_solve_multi_refined,
    cg_solve_refined,
    plan_dtype,
    plan_kind,
    plan_matrix,
    plan_semantics,
    spmm,
    spmv,
)
from tpusparse_torch.formats import dia
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.kernels import (
    dia_stream,
    ell_spmm,
    merge_spmv,
    spmm_merge,
)
from tpusparse_torch.ops.reference import spmv_numpy
from tpusparse_torch.utils.carry import plan_from_arrays

ROOT = Path(__file__).resolve().parent.parent
U = 2.0 ** -53
NORMWISE = 1e-13


def _mtx(name):
    return read_market(ROOT / "data" / "real" / f"{name}.mtx").to_csr()


# name: () -> port host CSR (float64 values)
MATRICES = {
    "lap2d-16": lambda: gen.make_laplacian_grid2d(16).to_csr(),
    "lap3d-8": lambda: gen.make_laplacian_grid3d(8).to_csr(),
    "lap3d-10": lambda: gen.make_laplacian_grid3d(10).to_csr(),
    "var-7-10": lambda: gen.make_variable_stencil(10).to_csr(),
    "var-27-6": lambda: gen.make_variable_stencil(6, full=True).to_csr(),
    "var-7-10-shift1": lambda: gen.make_variable_stencil(
        10, shift=1.0).to_csr(),
    "gr_30_30": lambda: _mtx("gr_30_30"),
    "Trefethen_200": lambda: _mtx("Trefethen_200"),
    "rmat_spd-10": lambda: gen.make_rmat_spd(10).to_csr(),
    "wheel-1000": lambda: gen.make_wheel(1000).to_csr(),
    "bibd_9_3": lambda: _mtx("bibd_9_3"),             # rectangular
    "empty-rows": lambda: CsrMatrix(6, 5, np.array([0, 0, 2, 2, 2, 3, 3]),
                                    np.array([1, 4, 0]),
                                    np.array([1.0, 2.0, 3.0])),
    "nnz-0": lambda: CsrMatrix(4, 4, np.zeros(5, np.int32),
                               np.zeros(0, np.int32), np.zeros(0)),
}
MASKED = ["lap2d-16", "lap3d-8", "gr_30_30"]          # K1d (and K5d)
PLANES = ["var-7-10", "var-27-6", "Trefethen_200"]    # K5d only
CSR = ["rmat_spd-10", "wheel-1000", "gr_30_30", "lap2d-16", "bibd_9_3"]
EDGES = ["empty-rows", "nnz-0"]


@functools.lru_cache(maxsize=None)
def _csr(name):
    """(port host CSR, JAX host CSR of the same arrays, float64 scipy)."""
    c = MATRICES[name]()
    ro = np.asarray(c.row_offsets, np.int32)
    ci = np.asarray(c.col_indices, np.int32)
    va = np.asarray(c.values, np.float64)
    port = CsrMatrix(c.num_rows, c.num_cols, ro, ci, va)
    S = sp.csr_matrix((va, ci, ro), shape=(c.num_rows, c.num_cols))
    return port, JCsr(c.num_rows, c.num_cols, ro, ci, va), S


@functools.lru_cache(maxsize=None)
def _dia(name):
    """(port host DIA, JAX host DIA) over the same selected diagonals."""
    port, jcsr, _ = _csr(name)
    offs = dia.select_diagonals(port)
    host, rest = dia.partition_dia(port, offs)
    jhost, _ = jdia.partition_dia(jcsr, offs)
    assert rest.nnz == 0
    return host, jhost


def _xt(L, n, seed=0):
    return np.random.default_rng(seed + L).standard_normal((L, n))


def _abs_dia(host, XT):
    """|A_dia| |X| as (L, num_rows)."""
    D = dia.to_device_dia(dia.DiaHost(host.num_rows, host.num_cols,
                                      host.offsets, np.abs(host.data)),
                          "cpu", torch.float64)
    return dia_stream.spmm_dia_planes_plain(D, torch.from_numpy(
        np.abs(XT))).numpy()


def _normwise(Y, Yj, AX):
    amax = AX.max() if AX.size else 0.0
    assert np.max(np.abs(Y - Yj), initial=0.0) <= NORMWISE * amax


def _k1d(host, XT):
    D = dia_stream.to_device_dia_stream(host, "cpu", torch.float64)
    assert D.vals.dtype == torch.float64
    return dia_stream.spmm_dia_stream_t(D, torch.from_numpy(XT)).numpy()


def _k5d(host, XT):
    D = dia.to_device_dia(host, "cpu", torch.float64)
    assert D.data.dtype == torch.float64
    return dia_stream.spmm_dia_planes_t(D, torch.from_numpy(XT)).numpy()


# --- K1d and K5d plain versions -------------------------------------------

@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("name", MASKED + PLANES)
def test_k1d_k5d_plain_match_xla_f64_dia(name, L):
    host, jhost = _dia(name)
    XT = _xt(L, host.num_cols)
    Dj = jdia.to_device_dia(jhost, dtype=np.float64)
    Yj = np.asarray(jops_dia.spmm_dia_t(Dj, jnp.asarray(XT)))
    bound = 2 * len(host.offsets) * U * _abs_dia(host, XT)
    Y5 = _k5d(host, XT)
    assert Y5.dtype == np.float64 and Y5.shape == Yj.shape
    assert np.all(np.abs(Y5 - Yj) <= bound)
    if name in MASKED:
        Y1 = _k1d(host, XT)
        assert np.all(np.abs(Y1 - Yj) <= bound)
        # the same products and sums in the same order
        np.testing.assert_array_equal(Y1, Y5)


# (fixture, L) of the double-float kernel comparisons
B11_CASES = [("lap3d-8", 1), ("lap3d-8", 3), ("lap3d-8", 16),
             ("gr_30_30", 3)]
B10_CASES = [("var-7-10", 1), ("var-7-10", 3), ("var-7-10", 16),
             ("Trefethen_200", 3), ("var-27-6", 1)]


@pytest.mark.parametrize("name,L", B11_CASES)
def test_k1d_plain_matches_b11_and_carries_it(name, L):
    host, jhost = _dia(name)
    XT = _xt(L, host.num_cols, seed=3)
    Dj = jds.to_device_dia_stream_df(jhost, masked=True)
    Yj = np.asarray(jds.spmm_dia_stream_df_t(Dj, jnp.asarray(XT)))
    AX = _abs_dia(host, XT)
    Y = _k1d(host, XT)
    _normwise(Y, Yj, AX)
    D = plan_from_arrays("dia_masked_df", {
        "mask_b": np.asarray(Dj.mask_b), "offsets": Dj.offsets,
        "vals_hi": Dj.vals_hi, "vals_lo": Dj.vals_lo,
        "shape": (Dj.num_rows, Dj.num_cols)}, "cpu")
    own = dia_stream.to_device_dia_stream(host, "cpu", torch.float64)
    assert D.vals.dtype == torch.float64 and D.offsets == own.offsets
    assert torch.equal(D.mask, own.mask)
    assert torch.all((D.vals - own.vals).abs() <= 2.0 ** -48 * own.vals.abs())
    _normwise(dia_stream.spmm_dia_stream_t(D, torch.from_numpy(XT)).numpy(),
              Yj, AX)


@pytest.mark.parametrize("name,L", B10_CASES)
def test_k5d_plain_matches_b10_and_carries_it(name, L):
    host, jhost = _dia(name)
    XT = _xt(L, host.num_cols, seed=4)
    Dj = jds.to_device_dia_stream_df(jhost, masked=False)
    Yj = np.asarray(jds.spmm_dia_stream_df_t(Dj, jnp.asarray(XT)))
    AX = _abs_dia(host, XT)
    _normwise(_k5d(host, XT), Yj, AX)
    D = plan_from_arrays("dia_df", {
        "data_hi": np.asarray(Dj.data_hi), "data_lo": np.asarray(Dj.data_lo),
        "offsets": Dj.offsets, "shape": (Dj.num_rows, Dj.num_cols)}, "cpu")
    own = dia.to_device_dia(host, "cpu", torch.float64)
    assert D.data.dtype == torch.float64 and D.offsets == own.offsets
    assert torch.all((D.data - own.data).abs() <= 2.0 ** -48 * own.data.abs())
    _normwise(dia_stream.spmm_dia_planes_t(D, torch.from_numpy(XT)).numpy(),
              Yj, AX)


def test_carried_xla_f64_dia_plan_equals_own():
    host, jhost = _dia("var-7-10")
    Dj = jdia.to_device_dia(jhost, dtype=np.float64)
    D = plan_from_arrays("dia", {"data": np.asarray(Dj.data),
                                 "offsets": Dj.offsets,
                                 "shape": (Dj.num_rows, Dj.num_cols)}, "cpu")
    own = dia.to_device_dia(host, "cpu", torch.float64)
    assert D.offsets == own.offsets and torch.equal(D.data, own.data)
    x = _xt(1, host.num_cols, seed=2)[0]
    y = spmv(D, torch.from_numpy(x)).numpy()
    yj = np.asarray(jops_dia.spmv_dia(Dj, jnp.asarray(x)))
    bound = 2 * len(host.offsets) * U * _abs_dia(host, x[None])[0]
    assert np.all(np.abs(y - yj) <= bound)


def test_k5d_takes_64_planes_and_rectangular_bands():
    rng = np.random.default_rng(6)
    offs = list(range(-40, 24))
    n, m = 300, 310
    S = sp.diags([rng.uniform(-2, 2, min(n, m - o) - max(0, -o))
                  for o in offs], offs, shape=(n, m)).tocsr()
    A = plan_matrix(CsrMatrix(n, m, S.indptr, S.indices, S.data), "dia",
                    dtype=np.float64, device="cpu")
    assert isinstance(A.dia, dia.DiaDevice) and len(A.dia.offsets) == 64
    assert A.dia.data.dtype == torch.float64 and A.rest is None
    X = rng.standard_normal((m, 3))
    Y = spmm(A, torch.from_numpy(X)).numpy()
    AX = abs(S) @ np.abs(X)
    assert np.all(np.abs(Y - S @ X) <= 64 * U * AX * 1.01)


# --- K2d, K3d and K4d plain versions ----------------------------------------

def _golden(S, X):
    """(float64 product, |A||X|, nnz per row as a column)."""
    nnz_i = np.diff(S.indptr)[:, None]
    return S @ X, abs(S) @ np.abs(X), nnz_i


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    return jplan(_csr(name)[1], "reference", dtype=np.float64)


@pytest.mark.parametrize("name", CSR + EDGES)
def test_k2d_plain_matches_golden_and_reference(name):
    port, _, S = _csr(name)
    M = merge_spmv.to_device_merge(port, "cpu", torch.float64)
    assert M.values.dtype == torch.float64
    x = _xt(1, port.num_cols, seed=5)[0]
    y = merge_spmv.merge_matvec(M, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float64 and y.shape == (port.num_rows,)
    exact, ax, nnz_i = _golden(S, x[:, None])
    np.testing.assert_array_equal(exact[:, 0], spmv_numpy(port, x))
    assert np.all(np.abs(y - exact[:, 0]) <= (nnz_i + 2)[:, 0] * U * ax[:, 0])
    if name not in EDGES:
        yj = np.asarray(jspmv(_jax_reference(name), jnp.asarray(x)))
        _normwise(y, yj, ax)


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("name", CSR + EDGES)
def test_k3d_k4d_plain_match_golden_and_reference(name, L):
    port, _, S = _csr(name)
    X = _xt(L, port.num_cols, seed=6).T.copy()
    exact, ax, nnz_i = _golden(S, X)
    Yj = (None if name in EDGES else
          np.asarray(jspmm(_jax_reference(name), jnp.asarray(X))))
    for plan, matmat in ((merge_spmv.to_device_merge,
                          spmm_merge.merge_matmat),
                         (ell_spmm.to_device_row_split,
                          ell_spmm.row_split_matmat)):
        A = plan(port, "cpu", torch.float64)
        Y = matmat(A, torch.from_numpy(X)).numpy()
        assert Y.dtype == np.float64 and Y.shape == (port.num_rows, L)
        assert np.all(np.abs(Y - exact) <= (nnz_i + 2) * U * ax)
        if Yj is not None:
            _normwise(Y, Yj, ax)


def test_k2d_plain_matches_b7_and_carried_csr():
    """B7 on the JAX double-float merge plan of rmat_spd-10 (its AUTO
    float64 single-RHS plan); the carried host CSR gives the port's own
    merge plan."""
    port, jcsr, S = _csr("rmat_spd-10")
    J = jplan(jcsr, "merge", dtype=np.float64)
    assert jplan_kind(J) == "merge_df64"
    x = _xt(1, port.num_cols, seed=7)[0]
    yj = np.asarray(jspmv(J, jnp.asarray(x)))
    _, ax, _ = _golden(S, x[:, None])
    M = plan_from_arrays("csr", {
        "row_offsets": np.asarray(jcsr.row_offsets),
        "col_indices": np.asarray(jcsr.col_indices),
        "values": np.asarray(jcsr.values), "shape": jcsr.shape}, "cpu",
        torch.float64)
    own = plan_matrix(port, "merge", dtype=np.float64, device="cpu")
    assert torch.equal(M.values, own.values)
    y = spmv(M, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, spmv(own, torch.from_numpy(x)).numpy())
    _normwise(y, yj, ax)


@functools.lru_cache(maxsize=None)
def _b8_rmat_spd():
    port, jcsr, _ = _csr("rmat_spd-10")
    X = _xt(16, port.num_cols, seed=8).T.copy()
    J = jplan(jcsr, "merge", dtype=np.float64, L=16)
    return X, np.asarray(jspmm(J, jnp.asarray(X)))


@pytest.mark.parametrize("L", [1, 3, 16])
def test_k3d_plain_matches_b8(L):
    port, _, S = _csr("rmat_spd-10")
    X16, Yj = _b8_rmat_spd()
    X = np.ascontiguousarray(X16[:, :L])
    A = plan_matrix(port, "merge", dtype=np.float64, L=L, device="cpu")
    Y = spmm_merge.spmm_merge_plain(A, torch.from_numpy(X)).numpy()
    _normwise(Y, Yj[:, :L], _golden(S, X)[1])


@pytest.mark.parametrize("L", [1, 3, 16])
def test_k4d_plain_matches_b9(L):
    port, jcsr, S = _csr("rmat_spd-10")
    J = jplan(jcsr, "row_split", dtype=np.float64, L=L)
    assert jplan_kind(J) == "row_split_df64"
    X = _xt(L, port.num_cols, seed=9).T.copy()
    Yj = np.asarray(jspmm(J, jnp.asarray(X)))
    A = plan_matrix(port, "row_split", dtype=np.float64, L=L, device="cpu")
    assert plan_kind(A) == "row_split"
    Y = ell_spmm.spmm_row_split_plain(A, torch.from_numpy(X)).numpy()
    _normwise(Y, Yj, _golden(S, X)[1])
    carried = plan_from_arrays("row_split", {
        "row_offsets": np.asarray(jcsr.row_offsets),
        "col_indices": np.asarray(jcsr.col_indices),
        "values": np.asarray(jcsr.values), "shape": jcsr.shape}, "cpu",
        torch.float64)
    np.testing.assert_array_equal(
        spmm(carried, torch.from_numpy(X)).numpy(), Y)


# --- the slice: plans, products, solvers ------------------------------------

# name: the port's float64 AUTO family (the JAX package plans the same
# family; its rmat_spd-10 plan is the double-float merge_df64)
AUTO_KINDS = {"lap3d-8": "dia", "gr_30_30": "dia", "var-7-10": "dia",
              "var-27-6": "dia", "Trefethen_200": "dia",
              "wheel-1000": "hybrid_dia", "rmat_spd-10": "merge"}


@pytest.mark.parametrize("name", list(AUTO_KINDS))
def test_auto_fp64_plans_family_and_ieee_semantics(name):
    port, jcsr, _ = _csr(name)
    for dtype in (np.float64, torch.float64, "float64"):
        for L in (1, 4):
            A = plan_matrix(port, "auto", dtype=dtype, L=L, device="cpu")
            assert plan_kind(A) == AUTO_KINDS[name]
            assert plan_semantics(A) == "ieee-f64"
            assert plan_dtype(A) == torch.float64
    A = plan_matrix(port, "auto", dtype=np.float64, device="cpu")
    if name in MASKED:
        assert isinstance(A.dia, dia_stream.DiaStreamDevice)
    elif name in PLANES:
        assert isinstance(A.dia, dia.DiaDevice)
    if A.__class__.__name__ == "HybridPlan" and A.rest is not None:
        assert A.rest.values.dtype == torch.float64
    J = jplan(jcsr, "auto", dtype=np.float64)
    assert jplan_kind(J).replace("_df64", "") == AUTO_KINDS[name]


@pytest.mark.parametrize("strategy,kind", [
    ("merge", "merge"), ("row_split", "row_split"), ("ell", "row_split"),
    ("simple", "row_split"), ("reference", "reference"), ("dia", "dia")])
def test_explicit_fp64_strategies(strategy, kind):
    port, _, S = _csr("gr_30_30")
    x = _xt(1, port.num_cols, seed=10)[0]
    exact, ax, nnz_i = _golden(S, x[:, None])
    for L in (1, 4):
        A = plan_matrix(port, strategy, dtype=np.float64, L=L, device="cpu")
        assert plan_kind(A) == kind and plan_semantics(A) == "ieee-f64"
        y = spmv(A, torch.from_numpy(x)).numpy()
        assert np.all(np.abs(y - exact[:, 0])
                      <= 2 * (nnz_i + 2)[:, 0] * U * ax[:, 0])


@pytest.mark.parametrize("name", ["lap3d-8", "var-7-10", "Trefethen_200",
                                  "gr_30_30", "rmat_spd-10"])
def test_spmv_spmm_match_jax_auto_fp64(name):
    port, jcsr, S = _csr(name)
    P = plan_matrix(port, "auto", dtype=np.float64, device="cpu")
    J = jplan(jcsr, "auto", dtype=np.float64)
    x = _xt(1, port.num_cols, seed=11)[0]
    y = spmv(P, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float64
    _normwise(y, np.asarray(jspmv(J, jnp.asarray(x))),
              _golden(S, x[:, None])[1])
    if name != "rmat_spd-10":     # its JAX SpMM is B8, checked above
        X = _xt(4, port.num_cols, seed=12).T.copy()
        Y = spmm(P, torch.from_numpy(X)).numpy()
        Yj = np.asarray(jspmm(jplan(jcsr, "auto", dtype=np.float64, L=4),
                              jnp.asarray(X)))
        _normwise(Y, Yj, _golden(S, X)[1])


def test_fp64_plans_never_round_through_float32():
    """Values 1 + 2^-40 survive a float64 plan of every family, and x is
    cast to the plan's type (a float32 x gives a float64 y)."""
    n = 64
    v = 1.0 + 2.0 ** -40
    S = sp.diags([np.full(n - 1, v), np.full(n, v), np.full(n - 1, v)],
                 [-1, 0, 1], format="csr")
    # plus one scattered entry
    R = (S + sp.coo_matrix(([v], ([0], [n - 1])), shape=(n, n))).tocsr()
    for M, strategies in ((S, ("auto", "merge", "row_split", "reference")),
                          (R, ("auto",))):
        csr = CsrMatrix(n, n, M.indptr, M.indices, M.data)
        x = np.full(n, 1.0 + 2.0 ** -30)
        for s in strategies:
            A = plan_matrix(csr, s, dtype=np.float64, device="cpu")
            y = spmv(A, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(y, M @ x, rtol=4 * U, atol=0)
            assert spmv(A, torch.from_numpy(x).float()).dtype \
                == torch.float64
    # the remainder of a float64 hybrid plan is float64 too
    A = plan_matrix(CsrMatrix(n, n, R.indptr, R.indices, R.data), "auto",
                    dtype=np.float64, device="cpu")
    assert plan_kind(A) == "hybrid_dia" and plan_dtype(A.rest) \
        == torch.float64


def test_mixed_dtype_kernel_calls_raise():
    port, _, _ = _csr("gr_30_30")
    n = port.num_rows
    for dtype, other in ((torch.float64, torch.float32),
                         (torch.float32, torch.float64)):
        host, _ = _dia("gr_30_30")
        D1 = dia_stream.to_device_dia_stream(host, "cpu", dtype)
        D5 = dia.to_device_dia(host, "cpu", dtype)
        M = merge_spmv.to_device_merge(port, "cpu", dtype)
        R = ell_spmm.to_device_row_split(port, "cpu", dtype)
        with pytest.raises(TypeError):
            dia_stream.spmm_dia_stream_t(D1, torch.zeros(1, n, dtype=other))
        with pytest.raises(TypeError):
            dia_stream.spmm_dia_planes_t(D5, torch.zeros(1, n, dtype=other))
        with pytest.raises(TypeError):
            merge_spmv.merge_matvec(M, torch.zeros(n, dtype=other))
        with pytest.raises(TypeError):
            spmm_merge.merge_matmat(M, torch.zeros(n, 2, dtype=other))
        with pytest.raises(TypeError):
            ell_spmm.row_split_matmat(R, torch.zeros(n, 2, dtype=other))
    with pytest.raises(TypeError):
        plan_matrix(port, dtype=np.float16, device="cpu")


# CG fixtures: the port's AUTO float64 plan (K1d, K5d, K2d) against the
# JAX strategy='reference' float64 CG
CG_NAMES = ["lap2d-16", "var-7-10", "gr_30_30", "rmat_spd-10"]


@pytest.mark.parametrize("name", CG_NAMES)
def test_cg_fp64_matches_jax_reference(name):
    port, jcsr, S = _csr(name)
    b = np.random.default_rng(13).standard_normal(port.num_rows)
    rj = jcg_solve(_jax_reference(name), jnp.asarray(b), tolerance=1e-10)
    P = plan_matrix(port, "auto", dtype=np.float64, device="cpu")
    r = cg_solve(P, torch.from_numpy(b), tolerance=1e-10,
                 record_history=True)
    assert r.x.dtype == r.history.dtype == torch.float64
    assert r.converged == bool(rj.converged) is True
    assert abs(r.iterations - int(rj.iterations)) <= 1
    x, xj = r.x.numpy(), np.asarray(rj.x)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-8
    assert np.linalg.norm(b - S @ x) / np.linalg.norm(b) < 1e-9


@pytest.mark.parametrize("name", CG_NAMES)
def test_cg_multi_fp64_matches_jax_reference(name):
    """B from seed 2. rmat_spd-10 amplifies rounding even in float64
    (ROADMAP C-ref6): with B from seed 14 the JAX reference and
    double-float plans take 159 and 160 iterations, the port 161 on its
    AUTO and on its reference plan alike."""
    port, jcsr, S = _csr(name)
    B = np.random.default_rng(2).standard_normal((port.num_rows, 4))
    rj = jcg_solve_multi(_jax_reference(name), jnp.asarray(B),
                         tolerance=1e-10)
    P = plan_matrix(port, "auto", dtype=np.float64, L=4, device="cpu")
    r = cg_solve_multi(P, torch.from_numpy(B), tolerance=1e-10)
    assert r.x.dtype == torch.float64
    np.testing.assert_array_equal(r.converged.numpy(),
                                  np.asarray(rj.converged))
    assert bool(r.converged.all())
    assert abs(r.iterations - int(rj.iterations)) <= 1
    X, Xj = r.x.numpy(), np.asarray(rj.x)
    assert np.all(np.linalg.norm(X - Xj, axis=0)
                  < 1e-8 * np.linalg.norm(Xj, axis=0))


def _direct(S, B, X):
    return (np.linalg.norm(B - S @ X, axis=0)
            / np.linalg.norm(B, axis=0))


@pytest.mark.parametrize("name", ["lap2d-16", "var-7-10-shift1"])
def test_cg_solve_refined_matches_jax(name):
    """The JAX package's test (``tests/test_solvers.py``): float32 AUTO
    inner plan, float64 reference residual plan; the port's residual
    plan is its float64 AUTO plan (K1d, K5d). The variable stencil has
    shift 1 (an implicit time step): near-singular, at shift 1e-2, the
    float32 inner solves at 1e-7 part by hundreds of iterations
    between any two float32 operators (819 in the JAX package, 637 in
    the port, both 4 refinements to 1.8e-15)."""
    port, jcsr, S = _csr(name)
    b = np.random.default_rng(15).standard_normal(port.num_rows)
    rj = jrefined(jplan(jcsr, dtype=np.float32), _jax_reference(name),
                  jnp.asarray(b))
    r = cg_solve_refined(plan_matrix(port, "auto", device="cpu",
                                     dtype=np.float32),
                         plan_matrix(port, "auto", dtype=np.float64,
                                     device="cpu"),
                         torch.from_numpy(b))
    assert r.x.dtype == torch.float64
    assert abs(r.refinements - int(rj.refinements)) <= 1
    assert r.refinements >= 2
    assert abs(r.inner_iterations - int(rj.inner_iterations)) \
        <= 2 * r.refinements
    assert float(r.residual) < 1e-12
    assert _direct(S, b, r.x.numpy()) < 1e-11


def test_cg_solve_multi_refined_matches_jax():
    """``tests/test_solvers.py``'s blocked case: lap3d-8 at L = 8, the
    same refinements and accuracy. The inner totals differ (ROADMAP
    C-ref7): the third inner solve, on a residual of about 6e-14
    relative, takes 3084 iterations on the JAX float32 AUTO plan (57 on
    its float32 reference plan) where the first two take 31, as every
    one does in the port."""
    port, jcsr, S = _csr("lap3d-8")
    B = np.random.default_rng(16).standard_normal((port.num_rows, 8))
    rj = jmulti_refined(jplan(jcsr, dtype=np.float32, L=8),
                        jplan(jcsr, dtype=np.float64, L=8), jnp.asarray(B))
    r = cg_solve_multi_refined(
        plan_matrix(port, "auto", L=8, device="cpu", dtype=np.float32),
        plan_matrix(port, "auto", dtype=np.float64, L=8, device="cpu"),
        torch.from_numpy(B))
    assert r.x.shape == (port.num_rows, 8) and r.residual.shape == (8,)
    assert r.refinements == int(rj.refinements) == 3
    assert r.inner_iterations == 3 * 31 < int(rj.inner_iterations)
    assert float(r.residual.max()) < 1e-11
    assert np.all(_direct(S, B, r.x.numpy()) < 1e-10)


def test_refinement_semantics_match_jax():
    """A zero b takes two empty refinements (the loop leaves only after
    k > 0); one allowed refinement stops there with the residual
    recomputed after the correction."""
    port, jcsr, _ = _csr("lap3d-10")
    A32 = plan_matrix(port, "auto", device="cpu", dtype=np.float32)
    A64 = plan_matrix(port, "auto", dtype=np.float64, device="cpu")
    J32, J64 = jplan(jcsr, dtype=np.float32), _jax_reference("lap3d-10")
    z = np.zeros(port.num_rows)
    r, rj = (cg_solve_refined(A32, A64, torch.from_numpy(z)),
             jrefined(J32, J64, jnp.asarray(z)))
    assert r.refinements == int(rj.refinements) == 2
    assert r.inner_iterations == int(rj.inner_iterations) == 0
    assert torch.all(r.x == 0)
    b = np.random.default_rng(17).standard_normal(port.num_rows)
    r = cg_solve_refined(A32, A64, torch.from_numpy(b), max_refinements=1)
    rj = jrefined(J32, J64, jnp.asarray(b), max_refinements=1)
    assert r.refinements == int(rj.refinements) == 1
    assert 1e-12 < float(r.residual) < 1e-5
    assert abs(float(r.residual) - float(rj.residual)) \
        <= 0.1 * float(rj.residual)
    with pytest.raises(ValueError, match=r"\(n, L\)"):
        cg_solve_multi_refined(A32, A64, torch.from_numpy(b))


def test_jax_reference_semantics_label():
    _, jcsr, _ = _csr("lap2d-16")
    assert jplan_semantics(_jax_reference("lap2d-16")) == "ieee-f64"
    assert jplan_semantics(jplan(jcsr, "merge", dtype=np.float64)) \
        == "double-float(~1e-14)"
