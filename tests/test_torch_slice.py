"""The slice end to end against the JAX package: host ingest ->
``plan_matrix(csr, "auto")`` -> ``spmv`` and ``cg_solve`` at tol 1e-5.

Each package ingests the fixture itself (the generators and the reader
give the same arrays, ``test_torch_host.py``); b and x come from numpy
seeds. The JAX side runs as its own tests run it (float32 plans,
Pallas in interpret mode on the CPU). Held to:

  * an SpMV within 1e-5 * max(|A||x|), with the same AUTO plan family
    (a non-constant band is value-plane DIA in both packages: B2 in
    JAX, K5 in the port);
  * CG: the same ``converged``, iterations within +-1, the port's
    float64 true residual < 1e-4, and ``||x_port - x_jax|| / ||x_jax||
    <= 1e-4``.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.ops.spmv import plan_kind as jplan_kind
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse.solvers.cg import cg_solve as jcg_solve
from tpusparse_torch import cg_solve, plan_kind, plan_matrix, spmv
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market

ROOT = Path(__file__).resolve().parent.parent
GR = ROOT / "data" / "real" / "gr_30_30.mtx"
TREF = ROOT / "data" / "real" / "Trefethen_200.mtx"

# name: (JAX ingest, port ingest, port AUTO family, JAX AUTO family)
FIXTURES = {
    "lap3d-12": (lambda: jgen.make_laplacian_grid3d(12),
                 lambda: gen.make_laplacian_grid3d(12), "dia", "dia"),
    "lap3d-16": (lambda: jgen.make_laplacian_grid3d(16),
                 lambda: gen.make_laplacian_grid3d(16), "dia", "dia"),
    "gr_30_30": (lambda: jread_market(GR), lambda: read_market(GR), "dia",
                 "dia"),
    "rmat_spd-10": (lambda: jgen.make_rmat_spd(10),
                    lambda: gen.make_rmat_spd(10), "merge", "merge"),
    "Trefethen_200": (lambda: jread_market(TREF),
                      lambda: read_market(TREF), "dia", "dia"),
    "varstencil-8": (lambda: jgen.make_variable_stencil(8),
                     lambda: gen.make_variable_stencil(8), "dia", "dia"),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX AUTO plan, port AUTO plan, float64 scipy matrix)."""
    jmake, pmake = FIXTURES[name][:2]
    jcsr, pcsr = jmake().to_csr(), pmake().to_csr()
    return (jplan(jcsr, "auto", dtype=np.float32),
            plan_matrix(pcsr, "auto", device="cpu", dtype=np.float32),
            pcsr.to_scipy().astype(np.float64))


def _b(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_auto_spmv_matches_jax(name):
    J, P, A64 = _pair(name)
    assert (plan_kind(P), jplan_kind(J)) == FIXTURES[name][2:]
    x = _b(A64.shape[1], seed=0)
    yj = np.asarray(jspmv(J, x))
    y = spmv(P, torch.from_numpy(x)).numpy()
    ax = abs(A64) @ np.abs(x).astype(np.float64)
    assert y.dtype == np.float32 and y.shape == yj.shape
    assert np.max(np.abs(y - yj)) <= 1e-5 * ax.max()


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cg_matches_jax(name):
    J, P, A64 = _pair(name)
    b = _b(A64.shape[0])
    rj = jcg_solve(J, b, max_iters=2000, tolerance=1e-5)
    r = cg_solve(P, torch.from_numpy(b), max_iters=2000, tolerance=1e-5)
    assert r.converged == bool(rj.converged)
    assert abs(r.iterations - int(rj.iterations)) <= 1
    x = r.x.numpy().astype(np.float64)
    xj = np.asarray(rj.x).astype(np.float64)
    b64 = b.astype(np.float64)
    assert np.linalg.norm(b64 - A64 @ x) / np.linalg.norm(b64) < 1e-4
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-4


def test_cg_zero_rhs_takes_no_iteration():
    J, P, A64 = _pair("lap3d-12")
    b = np.zeros(A64.shape[0], np.float32)
    rj = jcg_solve(J, b, max_iters=50, tolerance=1e-5, record_history=True)
    r = cg_solve(P, torch.from_numpy(b), max_iters=50, tolerance=1e-5,
                 record_history=True)
    assert r.iterations == int(rj.iterations) == 0
    assert r.converged and bool(rj.converged) and r.residual == 0.0
    assert torch.all(r.x == 0)
    assert torch.isnan(r.history).all() and r.history.shape == (50,)


def test_cg_history_and_iteration_cap():
    J, P, A64 = _pair("lap3d-12")
    b = _b(A64.shape[0])
    rj = jcg_solve(J, b, max_iters=40, tolerance=1e-5, record_history=True)
    r = cg_solve(P, torch.from_numpy(b), max_iters=40, tolerance=1e-5,
                 record_history=True)
    h, hj = r.history.numpy(), np.asarray(rj.history)
    k = r.iterations
    assert abs(k - int(rj.iterations)) <= 1
    assert np.isnan(h[k:]).all() and np.isfinite(h[:k]).all()
    m = min(k, int(rj.iterations))
    np.testing.assert_allclose(h[:m], hj[:m], rtol=1e-3)
    assert h[k - 1] == pytest.approx(r.residual, rel=1e-6)
    capped = cg_solve(P, torch.from_numpy(b), max_iters=5, tolerance=1e-5,
                      record_history=True)
    cj = jcg_solve(J, b, max_iters=5, tolerance=1e-5)
    assert capped.iterations == int(cj.iterations) == 5
    assert not capped.converged and not bool(cj.converged)
    assert np.isfinite(capped.history.numpy()).all()


def test_cg_on_merge_plan_matches_auto():
    pcsr = gen.make_laplacian_grid3d(12).to_csr()
    M = plan_matrix(pcsr, "merge", device="cpu", dtype=np.float32)
    _, P, A64 = _pair("lap3d-12")
    b = torch.from_numpy(_b(A64.shape[0]))
    r, rm = cg_solve(P, b), cg_solve(M, b)
    assert abs(r.iterations - rm.iterations) <= 1 and rm.converged
    assert torch.linalg.norm(r.x - rm.x) / torch.linalg.norm(r.x) <= 1e-4
