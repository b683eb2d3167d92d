"""Value-plane DIA (kernel K5's plain version) against the JAX package.

Both packages ingest the same fixture (the generators and the reader
give the same arrays, ``test_torch_host.py``) and split it into the same
diagonals. The JAX side runs as its own tests run it: the Pallas
value-plane kernel B2 (``_spmm_dia_stream_edge``) and its MXU-rotation
body B2' in interpret mode on ``to_device_dia_stream(dia,
block_rows=512, masked=False)``, and the XLA DIA op (``ops/dia.py``).
Each side is within gamma_K of the exact sum, so with u = 2^-24:

    |y_port - y_jax|_i <= 2 K u (|A| |x|)_i

(a hybrid row adds its remainder's entries and one more rounding to K).
bf16 planes must equal the JAX package's ``data_b`` bit for bit.
"""

import functools
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.formats import dia as jdia
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.kernels import dia_stream as jds
from tpusparse.ops import dia as jops_dia
from tpusparse.ops.spmv import plan_dia_bf16 as jplan_dia_bf16
from tpusparse.ops.spmv import plan_kind as jplan_kind
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import plan_semantics as jplan_semantics
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse.solvers.cg import cg_solve as jcg_solve
from tpusparse.solvers.cg import cg_solve_multi as jcg_solve_multi
from tpusparse_torch import (
    CsrMatrix,
    cg_solve,
    cg_solve_multi,
    plan_dia_bf16,
    plan_kind,
    plan_matrix,
    plan_semantics,
    spmm,
    spmv,
)
from tpusparse_torch.formats import dia
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.kernels import dia_stream
from tpusparse_torch.utils.carry import plan_from_arrays

ROOT = Path(__file__).resolve().parent.parent
U = 2.0 ** -24


def _band(n, m, offsets, seed):
    """scipy n x m band, random values on ``offsets``."""
    rng = np.random.default_rng(seed)
    return sp.diags([rng.uniform(-2, 2, min(n, m - o) - max(0, -o))
                     for o in offsets], offsets, shape=(n, m)).tocsr()


def _hybrid():
    """var-stencil-8 plus 300 symmetric entries off its band (seed 5)."""
    S = gen.make_variable_stencil(8).to_csr().to_scipy().tocoo()
    n = S.shape[0]
    band = set((S.col - S.row).tolist())
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, n, 300), rng.integers(0, n, 300)
    keep = np.array([(c - r) not in band and (r - c) not in band
                     for r, c in zip(rows, cols)])
    rows, cols = rows[keep], cols[keep]
    v = rng.uniform(-0.1, 0.1, rows.size)
    E = sp.coo_matrix((np.concatenate([v, v]),
                       (np.concatenate([rows, cols]),
                        np.concatenate([cols, rows]))), shape=(n, n))
    return (S + E).tocsr()


def _from_scipy(S):
    """(JAX CSR, port CSR) of one scipy matrix, float32 values."""
    S = S.tocsr()
    S.sort_indices()
    args = (S.shape[0], S.shape[1], S.indptr.astype(np.int32),
            S.indices.astype(np.int32), S.data.astype(np.float32))
    return JCsr(*args), CsrMatrix(*args)


TREF = ROOT / "data" / "real"

# name: () -> (JAX CSR, port CSR)
FIXTURES = {
    "var-7-8": lambda: (jgen.make_variable_stencil(8).to_csr(),
                        gen.make_variable_stencil(8).to_csr()),
    "var-27-12": lambda: (
        jgen.make_variable_stencil(12, full=True, seed=2).to_csr(),
        gen.make_variable_stencil(12, full=True, seed=2).to_csr()),
    "Trefethen_200": lambda: (
        jread_market(TREF / "Trefethen_200.mtx").to_csr(),
        read_market(TREF / "Trefethen_200.mtx").to_csr()),
    "Trefethen_20": lambda: (
        jread_market(TREF / "Trefethen_20.mtx").to_csr(),
        read_market(TREF / "Trefethen_20.mtx").to_csr()),
    "rect-130x135": lambda: _from_scipy(_band(130, 135, [-3, 0, 5], 1)),
    "neg-only-90": lambda: _from_scipy(_band(90, 90, [-40, -11], 2)),
    "hybrid-var-8": lambda: _from_scipy(_hybrid()),
}
# the Pallas stream kernels serve square operators only
SQUARE = [k for k in FIXTURES if not k.startswith("rect")]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX host DIA, port host DIA, port rest CSR, float64 scipy A)."""
    jcsr, pcsr = FIXTURES[name]()
    offs = dia.select_diagonals(pcsr)
    np.testing.assert_array_equal(offs, jdia.select_diagonals(jcsr))
    jhost, _ = jdia.partition_dia(jcsr, offs)
    host, rest = dia.partition_dia(pcsr, offs)
    return jhost, host, rest, pcsr.to_scipy().astype(np.float64)


def _xt(L, n, seed=0):
    return np.random.default_rng(seed + L).standard_normal(
        (L, n)).astype(np.float32)


def _bound(XT, Dhost):
    """2 K u (|A_dia||X|) per entry, (L, n)."""
    absA = sp.csr_matrix(abs(dia_host_scipy(Dhost)))
    return 2 * len(Dhost.offsets) * U * (absA @ np.abs(XT).T.astype(
        np.float64)).T


def dia_host_scipy(D):
    """The DIA part of a host plan as a float64 scipy matrix."""
    data = D.data.astype(np.float32).astype(np.float64)
    rows, cols, vals = [], [], []
    for k, off in enumerate(D.offsets):
        i = np.arange(D.num_rows)
        ok = (i + off >= 0) & (i + off < D.num_cols)
        rows.append(i[ok])
        cols.append(i[ok] + off)
        vals.append(data[k][ok])
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(D.num_rows, D.num_cols))


def _k5(host, XT, plane_dtype=torch.float32):
    D = dia.to_device_dia(host, "cpu", plane_dtype)
    return dia_stream.spmm_dia_planes_t(D, torch.from_numpy(XT)).numpy()


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("name", SQUARE)
def test_k5_plain_matches_b2_and_b2_mxu(name, L):
    jhost, host, _, _ = _case(name)
    n = host.num_rows
    XT = _xt(L, host.num_cols)
    Dj = jds.to_device_dia_stream(jhost, block_rows=512, masked=False)
    Yb2 = np.asarray(jds.spmm_dia_stream_t(Dj, jnp.asarray(XT)))
    XTP = np.zeros((L, jds.padded_cols(Dj)), np.float32)
    XTP[:, :n] = XT
    Ymxu = np.asarray(jds.spmm_dia_stream_tp(Dj, jnp.asarray(XTP),
                                             mxu=True))
    np.testing.assert_array_equal(Ymxu[:, n:], 0.0)
    Y = _k5(host, XT)
    assert Y.shape == (L, n) and Y.dtype == np.float32
    bound = _bound(XT, host)
    for Yj in (Yb2, Ymxu[:, :n]):
        assert np.all(np.abs(Y.astype(np.float64) - Yj) <= bound)


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_k5_plain_matches_xla_dia_op(name, L):
    jhost, host, _, _ = _case(name)
    XT = _xt(L, host.num_cols, seed=7)
    Dj = jdia.to_device_dia(jhost, dtype=np.float32)
    D = dia.to_device_dia(host, "cpu")
    bound = _bound(XT, host)
    Yt = dia_stream.spmm_dia_planes_t(D, torch.from_numpy(XT)).numpy()
    Ytj = np.asarray(jops_dia.spmm_dia_t(Dj, jnp.asarray(XT)))
    assert np.all(np.abs(Yt.astype(np.float64) - Ytj) <= bound)
    Y = spmm(D, torch.from_numpy(XT.T.copy())).numpy()
    Yj = np.asarray(jops_dia.spmm_dia(Dj, jnp.asarray(XT.T)))
    assert Y.shape == Yj.shape == (host.num_rows, L)
    assert np.all(np.abs(Y.astype(np.float64) - Yj) <= bound.T)
    y = spmv(D, torch.from_numpy(XT[0])).numpy()
    yj = np.asarray(jops_dia.spmv_dia(Dj, jnp.asarray(XT[0])))
    assert np.all(np.abs(y.astype(np.float64) - yj) <= bound[0])


@pytest.mark.parametrize("name", ["var-27-12", "Trefethen_200",
                                  "hybrid-var-8"])
def test_bf16_planes_equal_jax_bits(name):
    jhost, host, _, _ = _case(name)
    Dj = jds.to_device_dia_stream(jhost, block_rows=512, masked=False,
                                  plane_dtype=jnp.bfloat16)
    K, n = len(host.offsets), host.num_rows
    jb = np.asarray(Dj.data_b).transpose(1, 0, 2, 3).reshape(K, -1)[:, :n]
    D = dia.to_device_dia(host, "cpu", torch.bfloat16)
    assert D.data.dtype == torch.bfloat16 and D.data.shape == (K, n)
    np.testing.assert_array_equal(D.data.view(torch.int16).numpy(),
                                  jb.view(np.int16))
    # and K5 on bf16 planes is K5 on those planes upcast
    XT = _xt(3, n)
    D32 = dia.DiaDevice(n, host.num_cols, D.offsets, D.data.float())
    np.testing.assert_array_equal(
        dia_stream.spmm_dia_planes_t(D, torch.from_numpy(XT)).numpy(),
        dia_stream.spmm_dia_planes_t(D32, torch.from_numpy(XT)).numpy())


def test_bf16_rounds_through_float32():
    """f64 -> f32 -> bf16, as the JAX package rounds: 1 + 2^-8 + 2^-30
    lies above the bf16 tie 1 + 2^-8, so a correctly rounded f64 -> bf16
    cast gives 1 + 2^-7; the f32 step lands on the tie, which rounds to
    even, 1.0."""
    v = 1.0 + 2.0 ** -8 + 2.0 ** -30
    host = dia.DiaHost(2, 2, np.array([0]), np.array([[v, -v]]))
    got = dia.to_device_dia(host, "cpu", torch.bfloat16).data
    assert got.tolist() == [[1.0, -1.0]]
    data_b, _, _ = jds.prepare_stream(host, 512, plane_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        data_b.transpose(1, 0, 2, 3).reshape(1, -1)[:, :2].view(np.int16))


@pytest.mark.parametrize("name,kind", [("var-27-12", "dia"),
                                       ("Trefethen_200", "dia"),
                                       ("hybrid-var-8", "hybrid_dia"),
                                       ("rect-130x135", "dia")])
def test_plans_and_spmv_match_jax(name, kind):
    jcsr, pcsr = FIXTURES[name]()
    strategy = "dia" if name.startswith("rect") else "auto"
    J = jplan(jcsr, strategy, dtype=np.float32)
    P = plan_matrix(pcsr, strategy, device="cpu", dtype=np.float32)
    assert plan_kind(P) == jplan_kind(J) == kind
    assert plan_semantics(P) == jplan_semantics(J) == "f32"
    assert isinstance(P.dia, dia.DiaDevice)
    _, host, rest, A64 = _case(name)
    x = _xt(1, pcsr.num_cols, seed=3)[0]
    y = spmv(P, torch.from_numpy(x)).numpy()
    yj = np.asarray(jspmv(J, jnp.asarray(x)))
    gamma = 2 * (len(host.offsets) + np.diff(np.asarray(rest.row_offsets))
                 + 1) * U
    ax = abs(A64) @ np.abs(x).astype(np.float64)
    assert np.all(np.abs(y.astype(np.float64) - yj) <= gamma * ax)
    X = _xt(4, pcsr.num_cols, seed=4).T.copy()
    Y = spmm(P, torch.from_numpy(X)).numpy()
    assert Y.shape == (pcsr.num_rows, 4)
    assert np.all(np.abs(Y.astype(np.float64) - A64 @ X)
                  <= gamma[:, None] * (abs(A64) @ np.abs(X)))


def test_plan_dia_bf16_matches_jax():
    jcsr, pcsr = FIXTURES["var-27-12"]()
    J = jplan_dia_bf16(jcsr)
    P = plan_dia_bf16(pcsr, device="cpu")
    assert plan_kind(P) == jplan_kind(J) == "dia_bf16"
    assert plan_semantics(P) == jplan_semantics(J) == "bf16-plane(~4e-3)"
    x = _xt(1, pcsr.num_cols, seed=9)[0]
    y = spmv(P, torch.from_numpy(x)).numpy()
    yj = np.asarray(jspmv(J, jnp.asarray(x)))
    _, host, _, _ = _case("var-27-12")
    D16 = dia.to_device_dia(host, "cpu", torch.bfloat16)
    bound = _bound(x[None], dia.DiaHost(
        host.num_rows, host.num_cols, host.offsets,
        D16.data.float().numpy()))[0]
    assert np.all(np.abs(y.astype(np.float64) - yj) <= bound)


def test_plan_dia_bf16_hybrid_semantics_and_refusals():
    jcsr, pcsr = FIXTURES["hybrid-var-8"]()
    P, J = plan_dia_bf16(pcsr, device="cpu"), jplan_dia_bf16(jcsr)
    assert plan_kind(P) == jplan_kind(J) == "hybrid_dia_bf16"
    assert plan_semantics(P) == jplan_semantics(J) == "bf16-plane(~4e-3)"
    assert P.rest is not None and P.rest.values.dtype == torch.float32
    with pytest.raises(ValueError, match="square"):
        plan_dia_bf16(FIXTURES["rect-130x135"]()[1], device="cpu")
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 3000, 2000), rng.integers(0, 3000, 2000)
    S = sp.coo_matrix((np.ones(2000), (rows, cols)), shape=(3000, 3000))
    with pytest.raises(ValueError, match="diagonal"):
        plan_dia_bf16(_from_scipy(S)[1], device="cpu")
    lap = gen.make_laplacian_grid3d(6).to_csr()
    with pytest.warns(UserWarning, match="constant-coefficient"):
        Q = plan_dia_bf16(lap, device="cpu")
    assert isinstance(Q.dia, dia.DiaDevice) and plan_kind(Q) == "dia_bf16"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan_dia_bf16(pcsr, device="cpu")


@pytest.mark.parametrize("L", [1, 4])
def test_k5_equals_k1_on_constant_band(L):
    """Masked and value-plane kernels compute the same products in the
    same order: bit for bit on a constant-coefficient operator."""
    for csr in (gen.make_laplacian_grid3d(10).to_csr(),
                _from_scipy(abs(_band(300, 300, [-16, 0, 15], 3))
                            .sign() * 1.5)[1]):
        host, rest = dia.partition_dia(csr, dia.select_diagonals(csr))
        assert rest.nnz == 0
        D1 = dia_stream.to_device_dia_stream(host, "cpu")
        D5 = dia.to_device_dia(host, "cpu")
        XT = torch.from_numpy(_xt(L, csr.num_cols, seed=11))
        np.testing.assert_array_equal(
            dia_stream.spmm_dia_stream_t(D1, XT).numpy(),
            dia_stream.spmm_dia_planes_t(D5, XT).numpy())


def test_constant_band_plans_k1_and_wide_band_plans_k5():
    lap = gen.make_laplacian_grid3d(6).to_csr()
    assert isinstance(plan_matrix(lap, "auto", device="cpu",
                                  dtype=np.float32).dia,
                      dia_stream.DiaStreamDevice)
    # 40 constant diagonals: past the 32-bit mask, so value planes
    wide = _from_scipy(abs(_band(400, 400, list(range(-20, 20)), 4))
                       .sign())[1]
    P = plan_matrix(wide, "auto", device="cpu", dtype=np.float32)
    assert isinstance(P.dia, dia.DiaDevice) and len(P.dia.offsets) == 40
    x = torch.from_numpy(_xt(1, 400)[0])
    np.testing.assert_allclose(spmv(P, x).numpy(),
                               wide.to_scipy() @ x.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["dia", "dia_planes", "dia_planes_bf16"])
def test_carried_jax_plan_gives_same_y(kind):
    jhost, host, _, _ = _case("var-27-12")
    n = host.num_rows
    if kind == "dia":
        Dj = jdia.to_device_dia(jhost, dtype=np.float32)
        arrays = {"data": np.asarray(Dj.data)}
    else:
        pd = jnp.bfloat16 if kind.endswith("bf16") else np.float32
        Dj = jds.to_device_dia_stream(jhost, block_rows=512, masked=False,
                                      plane_dtype=pd)
        arrays = {"data_b": np.asarray(Dj.data_b)}
    arrays.update(offsets=Dj.offsets, shape=(n, Dj.num_cols))
    D = plan_from_arrays(kind[:10] if kind != "dia" else "dia", arrays,
                         "cpu")
    own = dia.to_device_dia(
        host, "cpu", torch.bfloat16 if kind.endswith("bf16")
        else torch.float32)
    assert D.offsets == own.offsets and torch.equal(D.data, own.data)
    x = _xt(1, n, seed=5)[0]
    y = spmv(D, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, spmv(own, torch.from_numpy(x))
                                  .numpy())
    yj = np.asarray(jds.spmv_dia_stream(Dj, jnp.asarray(x)) if kind != "dia"
                    else jops_dia.spmv_dia(Dj, jnp.asarray(x)))
    bound = _bound(x[None], dia.DiaHost(
        n, host.num_cols, host.offsets, own.data.float().numpy()))[0]
    assert np.all(np.abs(y.astype(np.float64) - yj) <= bound)


def test_carry_rejects_dirty_plane_pad():
    jhost, _, _, _ = _case("Trefethen_200")     # 200 rows in 512
    Dj = jds.to_device_dia_stream(jhost, block_rows=512, masked=False)
    data_b = np.asarray(Dj.data_b).copy()
    data_b.reshape(-1)[-1] = 1.0
    with pytest.raises(ValueError, match="zero pad"):
        plan_from_arrays("dia_planes", {
            "data_b": data_b, "offsets": Dj.offsets,
            "shape": (Dj.num_rows, Dj.num_cols)}, "cpu")


def test_zero_coefficient_times_inf_is_nan():
    """In-range loads multiply even a zero coefficient (0 * inf = nan,
    as on the TPU); out-of-range columns read 0 and stay finite."""
    _, host, _, _ = _case("var-7-8")           # offsets -64 -8 -1 0 1 8 64
    D = dia.to_device_dia(host, "cpu")
    x = torch.zeros(host.num_cols)
    x[8] = float("inf")
    y = spmv(D, x).numpy()
    # row 7 reaches column 8 through offset +1 with a zero coefficient
    # (grid-row wrap); row 0 through offset +8 with a real one
    assert host.data[list(D.offsets).index(1), 7] == 0
    assert np.isnan(y[7]) and np.isinf(y[0]) and y[1] == 0


def test_alpha_beta_and_rectangular_shapes():
    _, host, _, A64 = _case("rect-130x135")
    D = dia.to_device_dia(host, "cpu")
    x = torch.linspace(-1, 1, 135)
    y0 = torch.ones(130)
    np.testing.assert_allclose(
        spmv(D, x, alpha=2.0, beta=0.5, y=y0).numpy(),
        2.0 * (A64 @ x.numpy()) + 0.5, rtol=1e-5, atol=1e-5)
    X = torch.ones(135, 2)
    Y0 = torch.full((130, 2), 3.0)
    np.testing.assert_allclose(
        spmm(D, X, alpha=-1.0, beta=1.0, Y=Y0).numpy(),
        3.0 - A64 @ np.ones((135, 2)), rtol=1e-5, atol=1e-5)


def test_k5_wrapper_rejects_bad_operands():
    _, host, _, _ = _case("var-7-8")
    D = dia.to_device_dia(host, "cpu")
    n = host.num_rows
    # mixed types: float64 XT on float32 planes, float32 XT on float64
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_planes_t(D, torch.zeros(1, n,
                                                    dtype=torch.float64))
    with pytest.raises(ValueError):
        dia_stream.spmm_dia_planes_t(D, torch.zeros(1, n - 1))
    with pytest.raises(ValueError):
        dia_stream.spmm_dia_planes_t(D, torch.zeros(n, 2).t())
    Dm = dia.DiaDevice(n, n, D.offsets, D.data.to("meta"))
    with pytest.raises(ValueError, match="no K5 path"):
        dia_stream.spmm_dia_planes_t(Dm, torch.zeros(1, n, device="meta"))
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_planes_t(
            dia.to_device_dia(host, "cpu", torch.float64), torch.zeros(1, n))
    with pytest.raises(TypeError):
        dia.to_device_dia(host, "cpu", torch.float16)
    E = dia.DiaDevice(0, 5, (0,), torch.zeros(1, 0))
    assert dia_stream.spmm_dia_planes_t(E, torch.ones(2, 5)).shape == (2, 0)


# CG fixtures: the JAX package's bf16-refine operator (var-27-12, shift
# 1, lognormal conductivities at sigma 1) and the same at sigma 0.5. At
# sigma 1 the f32 residual recurrence amplifies the operators' last-bit
# differences (K5 rounds products and sums separately; XLA on the CPU
# rounds otherwise) to up to 23 % of the residual norm in mid-solve
# transients, which then decay: x, the iteration count and convergence
# still agree, so the history is held to rtol 1e-3 only at sigma 0.5,
# where the histories agree to about 1e-6.
CG_FIXTURES = {"var-27-12": (1.0, False), "var-27-12-sigma0.5": (0.5, True)}


@functools.lru_cache(maxsize=None)
def _cg_pair(name):
    """(JAX 'dia' plan, port 'dia' plan, float64 A, compare history)."""
    sigma, history = CG_FIXTURES[name]
    kw = dict(dims=3, full=True, seed=2, shift=1.0, sigma=sigma,
              dtype=np.float32)
    jcsr = jgen.make_variable_stencil(12, **kw).to_csr()
    pcsr = gen.make_variable_stencil(12, **kw).to_csr()
    P = plan_matrix(pcsr, "dia", device="cpu", dtype=np.float32)
    assert isinstance(P.dia, dia.DiaDevice) and P.rest is None
    return (jplan(jcsr, "dia", dtype=np.float32), P,
            pcsr.to_scipy().astype(np.float64), history)


@pytest.mark.parametrize("name", list(CG_FIXTURES))
def test_cg_on_value_planes_matches_jax(name):
    J, P, A64, history = _cg_pair(name)
    b = np.random.default_rng(21).standard_normal(A64.shape[0]).astype(
        np.float32)
    rj = jcg_solve(J, b, tolerance=1e-5, record_history=True)
    r = cg_solve(P, torch.from_numpy(b), tolerance=1e-5,
                 record_history=True)
    assert r.converged == bool(rj.converged) is True
    assert abs(r.iterations - int(rj.iterations)) <= 1
    x, xj = r.x.numpy().astype(np.float64), np.asarray(rj.x, np.float64)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-4
    m = min(r.iterations, int(rj.iterations))
    if history:
        np.testing.assert_allclose(r.history.numpy()[:m],
                                   np.asarray(rj.history)[:m], rtol=1e-3)


@pytest.mark.parametrize("name", list(CG_FIXTURES))
def test_cg_multi_on_value_planes_matches_jax(name):
    J, P, A64, history = _cg_pair(name)
    B = np.random.default_rng(22).standard_normal(
        (A64.shape[0], 4)).astype(np.float32)
    rj = jcg_solve_multi(J, B, tolerance=1e-5, record_history=True)
    r = cg_solve_multi(P, torch.from_numpy(B), tolerance=1e-5,
                       record_history=True)
    np.testing.assert_array_equal(r.converged.numpy(),
                                  np.asarray(rj.converged))
    assert bool(r.converged.all())
    assert abs(r.iterations - int(rj.iterations)) <= 1
    X, Xj = r.x.numpy().astype(np.float64), np.asarray(rj.x, np.float64)
    assert np.all(np.linalg.norm(X - Xj, axis=0)
                  <= 1e-4 * np.linalg.norm(Xj, axis=0))
    m = min(r.iterations, int(rj.iterations))
    if history:
        np.testing.assert_allclose(r.history.numpy()[:m],
                                   np.asarray(rj.history)[:m], rtol=1e-3)
