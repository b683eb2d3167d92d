"""Multi-RHS SpMM (the plain versions of kernels K3 and K4, and ``spmm``
dispatch) against the JAX package.

The JAX side is its own plans, run as its tests run them: float32, the
Pallas kernels B4 (``spmm_merge``, merge plan) and B5 (``spmm_ell``,
``row_split`` plan) in interpret mode on the CPU. Both packages ingest
the fixture themselves (the generators and the reader give the same
arrays, ``test_torch_host.py``); X comes from a numpy seed. With
u = 2^-24, the port is held to:

  * normwise ``max|Y - Y_jax| <= 1e-5 * max (|A||X|)`` against JAX (the
    JAX merge kernel forms row sums as differences of prefix sums, so
    its result is bounded only normwise, ROADMAP C-ref0);
  * ``|Y - Y64|_il <= (nnz_i + 2) u (|A||X|)_il`` against the float64
    product, entry by entry.

The JAX merge kernel costs seconds to compile per RHS width, so it runs
once per fixture at L = 16 and the port's product at L < 16 (on the
first L columns of the same X) is held to the first L columns of that
result: B4's lanes are independent of one another, which
``test_jax_merge_lanes_are_independent`` checks on one fixture.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.ops.spmv import plan_kind as jplan_kind
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse_torch import CsrMatrix, plan_kind, plan_matrix, spmm, spmv
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.kernels import ell_spmm, spmm_merge
from tpusparse_torch.utils.carry import plan_from_arrays

ROOT = Path(__file__).resolve().parent.parent
U = 2.0 ** -24
LS = (1, 3, 8, 16)
LMAX = 16


def _edge(pkg_csr, name):
    if name == "empty-rows":
        return pkg_csr(6, 5, np.array([0, 0, 2, 2, 2, 3, 3], np.int32),
                       np.array([1, 4, 0], np.int32),
                       np.array([1.0, 2.0, 3.0]))
    return pkg_csr(4, 4, np.zeros(5, np.int32), np.zeros(0, np.int32),
                   np.zeros(0))


# name: (JAX host CSR, port host CSR)
FIXTURES = {
    "rmat_spd-10": (lambda: jgen.make_rmat_spd(10).to_csr(),
                    lambda: gen.make_rmat_spd(10).to_csr()),
    "wheel-600": (lambda: jgen.make_wheel(600).to_csr(),
                  lambda: gen.make_wheel(600).to_csr()),
    "lap3d-8": (lambda: jgen.make_laplacian_grid3d(8).to_csr(),
                lambda: gen.make_laplacian_grid3d(8).to_csr()),
    "bibd_9_3": (lambda: jread_market(ROOT / "data/real/bibd_9_3.mtx")
                 .to_csr(),
                 lambda: read_market(ROOT / "data/real/bibd_9_3.mtx")
                 .to_csr()),
    "lesmis": (lambda: jread_market(ROOT / "data/real/lesmis.mtx").to_csr(),
               lambda: read_market(ROOT / "data/real/lesmis.mtx").to_csr()),
    "empty-rows": (lambda: _edge(JCsr, "empty-rows"),
                   lambda: _edge(CsrMatrix, "empty-rows")),
    "nnz-0": (lambda: _edge(JCsr, "nnz-0"), lambda: _edge(CsrMatrix, "nnz-0")),
}


@functools.lru_cache(maxsize=None)
def _fixture(name):
    """(JAX host CSR, port host CSR, X (num_cols, LMAX) float32)."""
    jmake, pmake = FIXTURES[name]
    jcsr, pcsr = jmake(), pmake()
    X = np.random.default_rng(3).standard_normal(
        (pcsr.num_cols, LMAX)).astype(np.float32)
    return jcsr, pcsr, X


@functools.lru_cache(maxsize=None)
def _jax_merge(name):
    """JAX merge-plan product (B4) at L = LMAX."""
    jcsr, _, X = _fixture(name)
    return np.asarray(jspmm(jplan(jcsr, "merge", dtype=np.float32, L=LMAX),
                            X))


@functools.lru_cache(maxsize=None)
def _jax_row_split_plan(name):
    return jplan(_fixture(name)[0], "row_split", dtype=np.float32, L=LMAX)


def _bounds(pcsr, X):
    """(float64 product, |A||X|, nnz per row as a column)."""
    A64 = pcsr.to_scipy().astype(np.float64)
    X64 = X.astype(np.float64)
    return (A64 @ X64, abs(A64) @ np.abs(X64),
            np.diff(np.asarray(pcsr.row_offsets))[:, None])


def _hold(Y, Yj, pcsr, X):
    exact, ax, nnz_i = _bounds(pcsr, X)
    assert Y.dtype == np.float32 and Y.shape == Yj.shape == exact.shape
    amax = ax.max() if ax.size else 0.0
    assert np.max(np.abs(Y - Yj), initial=0.0) <= 1e-5 * amax
    assert np.all(np.abs(Y.astype(np.float64) - exact)
                  <= (nnz_i + 2) * U * ax)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_k3_plain_matches_jax_merge(name, L):
    _, pcsr, X = _fixture(name)
    A = plan_matrix(pcsr, "merge", L=L, device="cpu", dtype=np.float32)
    assert plan_kind(A) == "merge"
    XL = np.ascontiguousarray(X[:, :L])
    Y = spmm_merge.spmm_merge_plain(A, torch.from_numpy(XL)).numpy()
    _hold(Y, _jax_merge(name)[:, :L], pcsr, XL)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_k4_plain_matches_jax_row_split(name, L):
    _, pcsr, X = _fixture(name)
    A = plan_matrix(pcsr, "row_split", L=L, device="cpu", dtype=np.float32)
    assert plan_kind(A) == "row_split"
    XL = np.ascontiguousarray(X[:, :L])
    Y = ell_spmm.spmm_row_split_plain(A, torch.from_numpy(XL)).numpy()
    Yj = np.asarray(jspmm(_jax_row_split_plan(name), XL))
    _hold(Y, Yj, pcsr, XL)


def test_jax_merge_lanes_are_independent():
    jcsr, pcsr, X = _fixture("lesmis")
    X3 = np.ascontiguousarray(X[:, :3])
    Y3 = np.asarray(jspmm(jplan(jcsr, "merge", dtype=np.float32, L=3), X3))
    _, ax, _ = _bounds(pcsr, X3)
    assert np.max(np.abs(Y3 - _jax_merge("lesmis")[:, :3])) \
        <= 1e-5 * ax.max()


# name: the AUTO family at L >= 2, the port's and the JAX package's
AUTO_KINDS = {"lap3d-8": "dia", "wheel-600": "hybrid_dia",
              "rmat_spd-10": "merge"}


@pytest.mark.parametrize("name", list(AUTO_KINDS))
def test_auto_spmm_matches_jax(name):
    """AUTO at L >= 2 plans the same family in both packages; the port's
    ``spmm`` through that plan (K1, K1 + K3, K3) is held to the JAX
    merge product of the same X."""
    jcsr, pcsr, X = _fixture(name)
    for L in (2, 4, LMAX):
        assert plan_kind(plan_matrix(pcsr, "auto", L=L, device="cpu",
                                     dtype=np.float32)) \
            == AUTO_KINDS[name]
    assert jplan_kind(jplan(jcsr, "auto", dtype=np.float32, L=LMAX)) \
        == AUTO_KINDS[name]
    P = plan_matrix(pcsr, "auto", L=LMAX, device="cpu", dtype=np.float32)
    Y = spmm(P, torch.from_numpy(X)).numpy()
    _hold(Y, _jax_merge(name), pcsr, X)


@pytest.mark.parametrize("strategy", ["row_split", "ell", "simple"])
def test_row_split_aliases_plan_k4(strategy):
    pcsr = gen.make_laplacian_grid3d(6).to_csr()
    for L in (1, 4, 16):
        A = plan_matrix(pcsr, strategy, L=L, device="cpu", dtype=np.float32)
        assert plan_kind(A) == "row_split"
        assert isinstance(A, ell_spmm.RowSplitDevice)


@pytest.mark.parametrize("strategy", ["auto", "merge", "row_split",
                                      "reference"])
@pytest.mark.parametrize("name", ["wheel-600", "rmat_spd-10"])
def test_spmm_alpha_beta_and_vector(name, strategy):
    _, pcsr, X = _fixture(name)
    P = plan_matrix(pcsr, strategy, L=4, device="cpu", dtype=np.float32)
    X4 = torch.from_numpy(np.ascontiguousarray(X[:, :4]))
    Y0 = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (pcsr.num_rows, 4)).astype(np.float32))
    Y = spmm(P, X4)
    np.testing.assert_allclose(
        spmm(P, X4, alpha=2.0, beta=-0.5, Y=Y0).numpy(),
        (2.0 * Y - 0.5 * Y0).numpy(), rtol=1e-6, atol=1e-5)
    x = X4[:, 1].contiguous()
    y = spmm(P, x)
    assert y.shape == (pcsr.num_rows,)
    np.testing.assert_array_equal(y.numpy(), Y[:, 1].numpy())
    np.testing.assert_allclose(y.numpy(), spmv(P, x).numpy(), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(
        spmm(P, x, alpha=3.0, beta=1.0, Y=Y0[:, 0].contiguous()).numpy(),
        (3.0 * y + Y0[:, 0]).numpy(), rtol=1e-6, atol=1e-5)


def test_spmm_alpha_beta_matches_jax():
    jcsr, pcsr, X = _fixture("rmat_spd-10")
    Y0 = np.random.default_rng(11).standard_normal(
        (pcsr.num_rows, LMAX)).astype(np.float32)
    Yj = np.asarray(jspmm(jplan(jcsr, "merge", dtype=np.float32, L=LMAX), X,
                          alpha=2.0, beta=-1.0, Y=Y0))
    Y = spmm(plan_matrix(pcsr, "merge", L=LMAX, device="cpu",
                         dtype=np.float32),
             torch.from_numpy(X), alpha=2.0, beta=-1.0,
             Y=torch.from_numpy(Y0)).numpy()
    _, ax, _ = _bounds(pcsr, X)
    assert np.max(np.abs(Y - Yj)) <= 2e-5 * ax.max() + 1e-6


def test_carried_jax_row_split_plan_gives_port_y():
    jcsr, pcsr, X = _fixture("rmat_spd-10")
    assert np.all(np.asarray(jcsr.values) != 0)  # pads and zeros read alike
    E = _jax_row_split_plan("rmat_spd-10")
    ell = plan_from_arrays("ell", {
        "vals": np.asarray(E.vals), "local_cols": np.asarray(E.local_cols),
        "row_block": np.asarray(E.row_block),
        "job_cblk": np.asarray(E.job_cblk), "shape": jcsr.shape}, "cpu")
    csr = plan_from_arrays("row_split", {
        "row_offsets": np.asarray(jcsr.row_offsets),
        "col_indices": np.asarray(jcsr.col_indices),
        "values": np.asarray(jcsr.values), "shape": jcsr.shape}, "cpu")
    own = plan_matrix(pcsr, "row_split", L=LMAX, device="cpu",
                      dtype=np.float32)
    assert plan_kind(ell) == plan_kind(csr) == "row_split"
    for name in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(ell, name).numpy(),
                                      getattr(own, name).numpy())
    Xt = torch.from_numpy(X)
    Y = spmm(own, Xt).numpy()
    np.testing.assert_array_equal(spmm(ell, Xt).numpy(), Y)
    np.testing.assert_array_equal(spmm(csr, Xt).numpy(), Y)
    _hold(Y, np.asarray(jspmm(E, X)), pcsr, X)


def test_spmm_wrappers_reject_bad_operands():
    pcsr = gen.make_laplacian_grid2d(4).to_csr()
    for strategy, matmat in (("merge", spmm_merge.merge_matmat),
                             ("row_split", ell_spmm.row_split_matmat)):
        A = plan_matrix(pcsr, strategy, device="cpu", dtype=np.float32)
        # mixed types: float64 X on a float32 operand
        with pytest.raises(TypeError):
            matmat(A, torch.zeros(16, 2, dtype=torch.float64))
        with pytest.raises(ValueError):
            matmat(A, torch.zeros(15, 2))
        with pytest.raises(ValueError):
            matmat(A, torch.zeros(16, 4)[:, ::2])
        with pytest.raises(ValueError):
            matmat(A, torch.zeros(16))
        meta = type(A)(16, 16, A.row_offsets.to("meta"),
                       A.col_indices.to("meta"), A.values.to("meta"))
        with pytest.raises(ValueError, match="no K[34] path"):
            matmat(meta, torch.zeros(16, 2, device="meta"))
        with pytest.raises(ValueError, match="same device"):
            matmat(meta, torch.zeros(16, 2))
    with pytest.raises(ValueError, match="L=0"):
        plan_matrix(pcsr, "auto", L=0, device="cpu", dtype=np.float32)
