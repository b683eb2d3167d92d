"""Blocked multi-RHS CG (``cg_solve_multi``) and the JAX package's
``entry()`` CG step, against the JAX package.

Each package ingests the fixture itself; B comes from a numpy seed. The
JAX side runs as its tests run it (float32 plans, Pallas in interpret
mode on the CPU): lap3d-12 on AUTO (the port's pure masked-DIA plan,
whose solve keeps the state in (L, n)), rmat_spd-10 on AUTO (merge, K3)
and gr_30_30 on ``row_split`` (K4). Held to, lane by lane: the same
``converged``, the port's float64 true residual < 1e-4, ``||x - x_jax||
/ ||x_jax|| <= 1e-4``, iterations within +-1 and the history within rtol
1e-3 up to the shorter run. Where the JAX package's own plan and its
``reference`` plan already differ, the port is held to that difference:
on rmat_spd-10 the residual curve amplifies rounding, the JAX package's
merge, row_split and reference plans part from one another at
iteration 8 of the history, and at L = 16 its merge and reference plans
take 102 and 101 iterations (the port 104: the largest lane's residual
sits at 1.1e-5 for three iterations). There the iteration allowance is
1 + that difference, and the history is held up to where the two JAX
plans part by more than 1e-3.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.solvers.cg import cg_solve_multi as jcg_solve_multi
from tpusparse_torch import cg_solve_multi, plan_kind, plan_matrix, spmm
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.ops.blas import (
    axpy_multiple,
    dot_multiple,
    update_p_multiple,
)

ROOT = Path(__file__).resolve().parent.parent
GR = ROOT / "data" / "real" / "gr_30_30.mtx"
MAX_ITERS = 2000

# name: (JAX ingest, port ingest, strategy, port plan family)
FIXTURES = {
    "lap3d-12": (lambda: jgen.make_laplacian_grid3d(12),
                 lambda: gen.make_laplacian_grid3d(12), "auto", "dia"),
    "rmat_spd-10": (lambda: jgen.make_rmat_spd(10),
                    lambda: gen.make_rmat_spd(10), "auto", "merge"),
    "gr_30_30": (lambda: jread_market(GR), lambda: read_market(GR),
                 "row_split", "row_split"),
}


@functools.lru_cache(maxsize=None)
def _jax_reference_run(name, L):
    """(iterations, history) of the JAX package's ``reference`` plan on
    the test's B."""
    jcsr = FIXTURES[name][0]().to_csr()
    r = jcg_solve_multi(jplan(jcsr, "reference", dtype=np.float32),
                        _B(jcsr.num_rows, L), max_iters=MAX_ITERS,
                        tolerance=1e-5)
    return int(r.iterations), np.asarray(r.history)


@functools.lru_cache(maxsize=None)
def _pair(name, L):
    """(JAX plan, port plan, float64 scipy matrix) at L right-hand
    sides."""
    jmake, pmake, strategy, _ = FIXTURES[name]
    jcsr, pcsr = jmake().to_csr(), pmake().to_csr()
    return (jplan(jcsr, strategy, dtype=np.float32, L=L),
            plan_matrix(pcsr, strategy, L=L, device="cpu", dtype=np.float32),
            pcsr.to_scipy().astype(np.float64))


def _B(n, L, seed=1):
    return np.random.default_rng(seed).standard_normal((n, L)).astype(
        np.float32)


def _solve_both(name, B):
    J, P, A64 = _pair(name, B.shape[1])
    rj = jcg_solve_multi(J, B, max_iters=MAX_ITERS, tolerance=1e-5)
    r = cg_solve_multi(P, torch.from_numpy(B), max_iters=MAX_ITERS,
                       tolerance=1e-5)
    return r, rj, A64


def _true_residual(A64, B, X):
    B64 = B.astype(np.float64)
    norms = np.linalg.norm(B64, axis=0)
    res = np.linalg.norm(B64 - A64 @ X.astype(np.float64), axis=0)
    return np.where(norms > 0, res / np.where(norms > 0, norms, 1), res)


@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_cg_multi_matches_jax(name, L):
    _, P, A64 = _pair(name, L)
    assert plan_kind(P) == FIXTURES[name][3]
    B = _B(A64.shape[0], L)
    r, rj, A64 = _solve_both(name, B)
    conv = r.converged.numpy()
    assert r.x.shape == (A64.shape[0], L) and r.residual.shape == (L,)
    np.testing.assert_array_equal(conv, np.asarray(rj.converged))
    assert conv.all()
    ref_iters, href = _jax_reference_run(name, L)
    assert abs(r.iterations - int(rj.iterations)) \
        <= 1 + abs(int(rj.iterations) - ref_iters)
    x, xj = r.x.numpy().astype(np.float64), np.asarray(rj.x, np.float64)
    assert np.all(_true_residual(A64, B, x) < 1e-4)
    assert np.all(np.linalg.norm(x - xj, axis=0)
                  <= 1e-4 * np.linalg.norm(xj, axis=0))
    h, hj = r.history.numpy(), np.asarray(rj.history)
    k = min(r.iterations, int(rj.iterations))
    jax_apart = np.flatnonzero(~(np.abs(hj[:k] - href[:k])
                                 <= 1e-3 * np.abs(href[:k])))
    k = int(jax_apart[0]) if jax_apart.size else k
    assert h.shape == (MAX_ITERS,) and k >= 5
    np.testing.assert_allclose(h[:k], hj[:k], rtol=1e-3)
    assert np.isnan(h[r.iterations:]).all()
    assert h[r.iterations - 1] == pytest.approx(float(r.residual.max()),
                                                rel=1e-6)


def test_cg_multi_zero_column_lane():
    B = _B(12 ** 3, 4)
    B[:, 2] = 0.0
    r, rj, A64 = _solve_both("lap3d-12", B)
    assert r.residual[2].item() == 0.0 and float(rj.residual[2]) == 0.0
    assert torch.all(r.x[:, 2] == 0)
    assert bool(r.converged.all()) and bool(np.all(rj.converged))
    assert abs(r.iterations - int(rj.iterations)) <= 1
    assert np.all(_true_residual(A64, B, r.x.numpy()) < 1e-4)


@pytest.mark.parametrize("name", ["lap3d-12", "gr_30_30"])
def test_cg_multi_zero_rhs_takes_one_iteration(name):
    _, _, A64 = _pair(name, 4)
    B = np.zeros((A64.shape[0], 4), np.float32)
    r, rj, _ = _solve_both(name, B)
    assert r.iterations == int(rj.iterations) == 1
    assert bool(r.converged.all()) and bool(np.all(rj.converged))
    assert torch.all(r.residual == 0) and torch.all(r.x == 0)
    assert r.history[0].item() == 0.0 and torch.isnan(r.history[1:]).all()


def test_cg_multi_iteration_cap_and_no_history():
    J, P, _ = _pair("lap3d-12", 4)
    B = _B(12 ** 3, 4)
    r = cg_solve_multi(P, torch.from_numpy(B), max_iters=5,
                       record_history=False)
    rj = jcg_solve_multi(J, B, max_iters=5, record_history=False)
    assert r.iterations == int(rj.iterations) == 5
    assert not r.converged.any() and not np.any(rj.converged)
    assert r.history.shape == (0,)
    np.testing.assert_allclose(r.residual.numpy(), np.asarray(rj.residual),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="B must be"):
        cg_solve_multi(P, torch.from_numpy(B[:, 0].copy()))


def test_entry_cg_step_matches_jax():
    """The JAX package's ``entry()`` step (lap3d-16, L = 16, one blocked
    CG iteration) against the same step through the port's ``spmm`` and
    multi-RHS BLAS-1."""
    step, (X0, B, P0, rs0) = __graft_entry__.entry()
    Xj, Rj, Pj, rsj = (np.asarray(a) for a in step(X0, B, P0, rs0))
    csr = gen.make_laplacian_grid3d(16, dtype=np.float32).to_csr()
    A = plan_matrix(csr, "auto", L=16, device="cpu", dtype=np.float32)
    assert plan_kind(A) == "dia"
    Bt = torch.from_numpy(np.array(B))
    X, R, P = torch.zeros_like(Bt), Bt, Bt
    rs_old = dot_multiple(Bt, Bt)
    AP = spmm(A, P)
    pAp = dot_multiple(P, AP)
    alpha = torch.where(pAp == 0, torch.zeros_like(pAp), rs_old / pAp)
    X = axpy_multiple(X, alpha, P)
    R = axpy_multiple(R, -alpha, AP)
    rs_new = dot_multiple(R, R)
    beta = torch.where(rs_old == 0, torch.zeros_like(rs_old),
                       rs_new / rs_old)
    P = update_p_multiple(R, beta, P)
    np.testing.assert_allclose(rs_old.numpy(), np.asarray(rs0), rtol=1e-5)
    for port, jax_v in ((X, Xj), (R, Rj), (P, Pj)):
        port = port.numpy().astype(np.float64)
        assert np.all(np.linalg.norm(port - jax_v, axis=0)
                      <= 1e-5 * np.linalg.norm(jax_v, axis=0))
    np.testing.assert_allclose(rs_new.numpy(), rsj, rtol=1e-5)


def _scrambled(width=16, seed=4):
    """(JAX host CSR of a scrambled lap2d, the port's CsrMatrix of it)."""
    from tpusparse.ops.reorder import permute_symmetric as jpermute
    from tpusparse_torch import CsrMatrix

    j = jgen.make_laplacian_grid2d(width).to_csr()
    j = jpermute(j, np.random.default_rng(seed).permutation(j.num_rows))
    return j, CsrMatrix(j.num_rows, j.num_cols, np.asarray(j.row_offsets),
                        np.asarray(j.col_indices), np.asarray(j.values))


def _same_solve(r, rj, what):
    """The same converged flag, iterations within 1, history within 1e-3
    up to the shorter run, and x within 1e-4."""
    assert bool(np.all(np.asarray(r.converged))) \
        == bool(np.all(np.asarray(rj.converged))), what
    assert abs(int(r.iterations) - int(rj.iterations)) <= 1, what
    k = min(int(r.iterations), int(rj.iterations))
    np.testing.assert_allclose(r.history[:k].numpy(),
                               np.asarray(rj.history)[:k], rtol=1e-3)
    x, xj = r.x.numpy().astype(np.float64), np.asarray(rj.x, np.float64)
    assert np.linalg.norm(x - xj) <= 1e-4 * np.linalg.norm(xj), what


# (case, reorder): the warm start on a plain and on a reordered plan
@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_cg_solve_x0_matches_jax(reorder):
    """``cg_solve(..., x0=...)``: r = b - A x0, the convergence threshold
    on ||b||; on a ReorderedPlan the JAX dispatch route (the plan's spmv
    permutes around each product), as the JAX package takes it."""
    from tpusparse.solvers.cg import cg_solve as jcg_solve
    from tpusparse_torch import cg_solve

    j, c = _scrambled()
    rng = np.random.default_rng(40)
    b = rng.standard_normal(j.num_rows)
    x0 = 0.5 * rng.standard_normal(j.num_rows)
    # float64: the JAX package permutes float64 vectors with XLA's gather
    # (its float32 path runs the interpret-mode permute kernel per
    # product on this unjitted route)
    jA = jplan(j, "reference", dtype=np.float64, reorder=reorder)
    A = plan_matrix(c, "merge", dtype=np.float64, reorder=reorder,
                    device="cpu")
    rj = jcg_solve(jA, b, x0=x0, record_history=True, max_iters=500)
    r = cg_solve(A, torch.from_numpy(b), x0=torch.from_numpy(x0),
                 record_history=True, max_iters=500)
    _same_solve(r, rj, f"x0 reorder={reorder}")
    # an exact warm start takes no iteration
    r0 = cg_solve(A, torch.from_numpy(b), x0=r.x)
    assert r0.iterations <= 1


def test_cg_solve_matvec_matches_jax():
    """A matrix-free ``matvec`` replaces the plan's product."""
    from tpusparse.ops.spmv import spmv as jspmv
    from tpusparse.solvers.cg import cg_solve as jcg_solve
    from tpusparse_torch import cg_solve, spmv

    j, c = _scrambled()
    b = np.random.default_rng(41).standard_normal(j.num_rows).astype(
        np.float32)
    jA = jplan(j, "reference", dtype=np.float32)
    A = plan_matrix(c, "merge", device="cpu", dtype=np.float32)
    rj = jcg_solve(None, b, matvec=lambda v: jspmv(jA, v),
                   record_history=True, max_iters=500)
    r = cg_solve(None, torch.from_numpy(b), matvec=lambda v: spmv(A, v),
                 record_history=True, max_iters=500)
    _same_solve(r, rj, "matvec")


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_cg_solve_multi_matmat_matches_jax(reorder):
    """``cg_solve_multi(..., matmat=...)``: the custom product replaces
    the plan's, with no permuted-space solve on a reordered plan."""
    from tpusparse.ops.spmv import spmm as jspmm

    j, c = _scrambled()
    B = _B(j.num_rows, 3, seed=42)
    jA = jplan(j, "reference", dtype=np.float32)
    M = plan_matrix(c, "merge", L=3, device="cpu", dtype=np.float32)
    A = plan_matrix(c, "merge", L=3, reorder=reorder, device="cpu",
                    dtype=np.float32)
    rj = jcg_solve_multi(jplan(j, "reference", dtype=np.float32,
                               reorder=reorder), B,
                         matmat=lambda V: jspmm(jA, V), max_iters=500)
    calls = []

    def matmat(V):
        calls.append(V.shape)
        return spmm(M, V)

    r = cg_solve_multi(A, torch.from_numpy(B), matmat=matmat, max_iters=500)
    assert len(calls) == r.iterations
    _same_solve(r, rj, f"matmat reorder={reorder}")
