"""The port's public signatures and defaults against the JAX package's.

* The default plan type. ``plan_matrix(csr)`` and ``plan_matrix(csr,
  reorder='rcm')`` plan in the host values' type, as the JAX package's
  ``dtype=None`` does (``tpusparse/ops/spmv.py``: ``np.asarray(
  csr.values).dtype``), on the generators' fixtures and every
  ``data/real/*.mtx``.
* The call forms. Each solver and ``spmv``/``spmm`` take JAX's
  arguments in JAX's order, ``strategy`` among them (validated, as the
  JAX product on a plan does not depend on it) and ``bake`` where JAX
  has it (ignored). The same positional and keyword calls run in both
  packages on the same seeded numpy inputs and agree within each
  solver's contract: the same ``converged``, iterations within 1 (the
  bf16-plane solvers within 2, ROADMAP C-ref2; a refinement's inner
  total within 1 per refinement), products within the float32 rounding
  bound. An unknown strategy raises ValueError in both.
* A host ``CsrMatrix`` (numpy arrays) given to ``spmv``, ``spmm``,
  ``cg_solve`` or ``cg_solve_multi`` runs the reference product on the
  vector's device in the vector's type, as the JAX package's does.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.ops.spmv import plan_dia_bf16 as jplan_dia_bf16
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse.solvers import cg as jcg
from tpusparse.solvers import pcg as jpcg
from tpusparse.solvers import refine as jrefine
from tpusparse.solvers import spai_cg as jspai_cg
from tpusparse_torch import (
    CsrMatrix,
    cg_solve,
    cg_solve_bf16,
    cg_solve_multi,
    cg_solve_multi_refined,
    cg_solve_multi_refined_f32,
    cg_solve_refined,
    cg_solve_refined_f32,
    pcg_solve_multi,
    plan_dia_bf16,
    plan_dtype,
    plan_matrix,
    plan_semantics,
    spai_cg_solve_multi,
    spmm,
    spmv,
)
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market

ROOT = Path(__file__).resolve().parent.parent
U = 2.0 ** -24

# name -> (port generator call, JAX generator call), small sizes
GENERATORS = {
    "lap2d-20": lambda g: g.make_laplacian_grid2d(20),
    "lap3d-8": lambda g: g.make_laplacian_grid3d(8),
    "lap2d-20-f32": lambda g: g.make_laplacian_grid2d(20, dtype=np.float32),
    "var-7-8": lambda g: g.make_variable_stencil(8),
    "var-27-6-f32": lambda g: g.make_variable_stencil(
        6, full=True, seed=2, dtype=np.float32),
    "rmat-9": lambda g: g.make_rmat(9, edge_factor=4),
    "rmat_spd-9": lambda g: g.make_rmat_spd(9, edge_factor=4),
    "wheel-300": lambda g: g.make_wheel(300),
    "fem2d-500": lambda g: g.make_fem2d(500, seed=1),
    "block_random-8": lambda g: g.make_block_random(8, 2),
}
REAL = sorted(p.name for p in (ROOT / "data" / "real").glob("*.mtx"))


def _fixture(name):
    """(port host CSR, JAX host CSR) of a generator or a real matrix."""
    if name in GENERATORS:
        return (GENERATORS[name](gen).to_csr(),
                GENERATORS[name](jgen).to_csr())
    path = ROOT / "data" / "real" / name
    return read_market(path).to_csr(), jread_market(path).to_csr()


def _torch_dtype(np_dtype):
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(np_dtype)]


@pytest.mark.parametrize("name", list(GENERATORS) + REAL)
def test_default_plan_type_is_the_host_values(name):
    """``plan_matrix(csr)`` and its RCM plan take the host values' type,
    the type the JAX package's ``dtype=None`` plans in."""
    pcsr, jcsr = _fixture(name)
    want = _torch_dtype(np.asarray(jcsr.values).dtype)
    assert want == _torch_dtype(np.asarray(pcsr.values).dtype)
    P = plan_matrix(pcsr, device="cpu")
    assert plan_dtype(P) == want
    assert plan_semantics(P) == ("ieee-f64" if want == torch.float64
                                 else "f32")
    if pcsr.num_rows == pcsr.num_cols:
        R = plan_matrix(pcsr, reorder="rcm", device="cpu")
        assert plan_dtype(R) == want
    assert plan_dtype(plan_matrix(pcsr, dtype=np.float32,
                                  device="cpu")) == torch.float32


def test_value_dtype_takes_none_only_through_the_plan():
    from tpusparse_torch.formats.csr import value_dtype

    with pytest.raises(TypeError):
        value_dtype(None)


@functools.lru_cache(maxsize=None)
def _spd():
    """lap2d-16 (256 rows) as host CSRs and reference plans in float32
    and float64 of both packages, and a Jacobi preconditioner's
    diagonal."""
    pcsr = gen.make_laplacian_grid2d(16).to_csr()
    jcsr = jgen.make_laplacian_grid2d(16).to_csr()
    diag = np.asarray(pcsr.to_scipy().diagonal())
    return dict(
        pcsr=pcsr, jcsr=jcsr, diag=diag,
        p32=plan_matrix(pcsr, "reference", dtype=np.float32, device="cpu"),
        p64=plan_matrix(pcsr, "reference", dtype=np.float64, device="cpu"),
        j32=jplan(jcsr, "reference", dtype=np.float32),
        j64=jplan(jcsr, "reference", dtype=np.float64))


def _rhs(n, L, seed, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((n, L) if L else n)
    return x.astype(dtype)


def _iters(res):
    return int(res.iterations)


def _conv(res):
    return np.asarray(res.converged).tolist()


@pytest.mark.parametrize("style", ["positional", "keyword"])
def test_cg_solve_calls_match_jax(style):
    s = _spd()
    b = _rhs(s["pcsr"].num_rows, 0, 1)
    if style == "positional":
        r = cg_solve(s["p32"], torch.from_numpy(b), 500, 1e-5, "auto",
                     None, None, True, False)
        j = jcg.cg_solve(s["j32"], jnp.asarray(b), 500, 1e-5, "auto", None,
                         None, True, False)
    else:
        r = cg_solve(s["p32"], torch.from_numpy(b), max_iters=500,
                     tolerance=1e-5, strategy="reference",
                     record_history=True, bake=None)
        j = jcg.cg_solve(s["j32"], jnp.asarray(b), max_iters=500,
                         tolerance=1e-5, strategy="reference",
                         record_history=True, bake=None)
    assert abs(_iters(r) - _iters(j)) <= 1 and r.converged == bool(
        j.converged)
    assert r.history.shape == (500,)


@pytest.mark.parametrize("style", ["positional", "keyword"])
def test_cg_solve_multi_calls_match_jax(style):
    s = _spd()
    B = _rhs(s["pcsr"].num_rows, 3, 2)
    if style == "positional":
        r = cg_solve_multi(s["p32"], torch.from_numpy(B), 500, 1e-5, "auto",
                           None, False, False)
        j = jcg.cg_solve_multi(s["j32"], jnp.asarray(B), 500, 1e-5, "auto",
                               None, False, False)
    else:
        r = cg_solve_multi(s["p32"], torch.from_numpy(B), max_iters=500,
                           tolerance=1e-5, strategy="merge", bake=True)
        j = jcg.cg_solve_multi(s["j32"], jnp.asarray(B), max_iters=500,
                               tolerance=1e-5, strategy="merge", bake=False)
    assert abs(_iters(r) - _iters(j)) <= 1
    assert r.converged.tolist() == _conv(j)


@pytest.mark.parametrize("style", ["positional", "keyword"])
def test_pcg_and_spai_cg_calls_match_jax(style):
    """``pcg_solve_multi`` with a Jacobi preconditioner and
    ``spai_cg_solve_multi`` with M = D^-1, in JAX's argument order."""
    s = _spd()
    B = _rhs(s["pcsr"].num_rows, 2, 3)
    inv = (1.0 / s["diag"]).astype(np.float32)
    n = inv.shape[0]
    idx = np.arange(n)
    Mp = plan_matrix(CsrMatrix(n, n, np.arange(n + 1), idx, inv),
                     "reference", dtype=np.float32, device="cpu")
    Mj = jplan(JCsr(n, n, np.arange(n + 1), idx, inv), "reference",
               dtype=np.float32)
    tinv, jinv = torch.from_numpy(inv)[:, None], jnp.asarray(inv)[:, None]
    Bt, Bj = torch.from_numpy(B), jnp.asarray(B)
    if style == "positional":
        r = pcg_solve_multi(s["p32"], Bt, lambda R: R * tinv, 500, 1e-5,
                            "auto", None, True)
        j = jpcg.pcg_solve_multi(s["j32"], Bj, lambda R: R * jinv, 500, 1e-5,
                                 "auto", None, True)
        r2 = spai_cg_solve_multi(s["p32"], Mp, Bt, 500, 1e-5, "auto", True)
        j2 = jspai_cg.spai_cg_solve_multi(s["j32"], Mj, Bj, 500, 1e-5,
                                          "auto", True)
    else:
        r = pcg_solve_multi(s["p32"], Bt, lambda R: R * tinv,
                            max_iters=500, tolerance=1e-5,
                            strategy="reference", record_history=False)
        j = jpcg.pcg_solve_multi(s["j32"], Bj, lambda R: R * jinv,
                                 max_iters=500, tolerance=1e-5,
                                 strategy="reference", record_history=False)
        r2 = spai_cg_solve_multi(s["p32"], Mp, Bt, max_iters=500,
                                 tolerance=1e-5, strategy="reference")
        j2 = jspai_cg.spai_cg_solve_multi(s["j32"], Mj, Bj, max_iters=500,
                                          tolerance=1e-5,
                                          strategy="reference")
    for a, b in ((r, j), (r2, j2)):
        assert abs(_iters(a) - _iters(b)) <= 1
        assert a.converged.tolist() == _conv(b)


def _refined_agree(r, j):
    assert r.refinements == int(j.refinements)
    assert abs(int(r.inner_iterations) - int(j.inner_iterations)) <= \
        r.refinements
    assert bool(torch.all(r.residual < 1e-11)) == bool(
        np.all(np.asarray(j.residual) < 1e-11))


@pytest.mark.parametrize("style", ["positional", "keyword"])
def test_fp64_refinement_calls_match_jax(style):
    s = _spd()
    b = _rhs(s["pcsr"].num_rows, 0, 4, np.float64)
    B = _rhs(s["pcsr"].num_rows, 2, 5, np.float64)
    if style == "positional":
        r = cg_solve_refined(s["p32"], s["p64"], torch.from_numpy(b), 1e-12,
                             1e-7, 10000, 8, "auto")
        j = jrefine.cg_solve_refined(s["j32"], s["j64"], jnp.asarray(b),
                                     1e-12, 1e-7, 10000, 8, "auto")
        rm = cg_solve_multi_refined(s["p32"], s["p64"], torch.from_numpy(B),
                                    1e-12, 1e-7, 10000, 8, "auto")
        jm = jrefine.cg_solve_multi_refined(s["j32"], s["j64"],
                                            jnp.asarray(B), 1e-12, 1e-7,
                                            10000, 8, "auto")
    else:
        kw = dict(tolerance=1e-12, max_refinements=8, strategy="reference")
        r = cg_solve_refined(s["p32"], s["p64"], torch.from_numpy(b), **kw)
        j = jrefine.cg_solve_refined(s["j32"], s["j64"], jnp.asarray(b),
                                     **kw)
        rm = cg_solve_multi_refined(s["p32"], s["p64"], torch.from_numpy(B),
                                    **kw)
        jm = jrefine.cg_solve_multi_refined(s["j32"], s["j64"],
                                            jnp.asarray(B), **kw)
    _refined_agree(r, j)
    _refined_agree(rm, jm)


@functools.lru_cache(maxsize=None)
def _bf16():
    """var27 (width 10, shift 1) bf16-plane and float32 plans of both
    packages, as ``test_torch_refine.py`` builds them."""
    kw = dict(dims=3, full=True, seed=2, shift=1.0, dtype=np.float32)
    jcsr = jgen.make_variable_stencil(10, **kw).to_csr()
    pcsr = gen.make_variable_stencil(10, **kw).to_csr()
    return ((jplan_dia_bf16(jcsr), jplan(jcsr, "dia", dtype=np.float32)),
            (plan_dia_bf16(pcsr, device="cpu"),
             plan_matrix(pcsr, "dia", dtype=np.float32, device="cpu")),
            pcsr.num_rows)


@pytest.mark.parametrize("style", ["positional", "keyword"])
def test_bf16_solver_calls_match_jax(style):
    """``cg_solve_bf16``, ``cg_solve_refined_f32`` and
    ``cg_solve_multi_refined_f32`` with ``strategy`` and ``bake`` in
    JAX's places (JAX unbaked, as ``test_torch_refine.py`` runs it)."""
    (J16, J32), (P16, P32), n = _bf16()
    b = _rhs(n, 0, 6)
    B = _rhs(n, 2, 7)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    Bt, Bj = torch.from_numpy(B), jnp.asarray(B)
    if style == "positional":
        r = cg_solve_bf16(P16, P32, bt, 1e-5, 10000, 8, 3, "auto", False)
        j = jrefine.cg_solve_bf16(J16, J32, bj, 1e-5, 10000, 8, 3, "auto",
                                  False)
        rr = cg_solve_refined_f32(P16, P32, bt, 1e-5, 1e-2, 1000, 12,
                                  "auto", False)
        jr = jrefine.cg_solve_refined_f32(J16, J32, bj, 1e-5, 1e-2, 1000, 12,
                                          "auto", False)
        rm = cg_solve_multi_refined_f32(P16, P32, Bt, 1e-5, 1e-2, 1000, 12,
                                        "auto", False)
        jm = jrefine.cg_solve_multi_refined_f32(J16, J32, Bj, 1e-5, 1e-2,
                                                1000, 12, "auto", False)
    else:
        kw = dict(tolerance=1e-5, strategy="dia", bake=False)
        r = cg_solve_bf16(P16, P32, bt, **kw)
        j = jrefine.cg_solve_bf16(J16, J32, bj, **kw)
        rr = cg_solve_refined_f32(P16, P32, bt, **kw)
        jr = jrefine.cg_solve_refined_f32(J16, J32, bj, **kw)
        rm = cg_solve_multi_refined_f32(P16, P32, Bt, **kw)
        jm = jrefine.cg_solve_multi_refined_f32(J16, J32, Bj, **kw)
    assert r.converged == bool(j.converged)
    assert abs(_iters(r) - _iters(j)) <= 2
    for a, c in ((rr, jr), (rm, jm)):
        assert a.refinements == int(c.refinements)
        assert abs(int(a.inner_iterations) - int(c.inner_iterations)) <= \
            2 * a.refinements


@pytest.mark.parametrize("style", ["positional", "keyword"])
def test_spmv_spmm_calls_match_jax(style):
    s = _spd()
    n = s["pcsr"].num_rows
    x, y0 = _rhs(n, 0, 8), _rhs(n, 0, 9)
    X, Y0 = _rhs(n, 4, 10), _rhs(n, 4, 11)
    if style == "positional":
        y = spmv(s["p32"], torch.from_numpy(x), 2.0, 0.5,
                 torch.from_numpy(y0), "auto")
        yj = jspmv(s["j32"], jnp.asarray(x), 2.0, 0.5, jnp.asarray(y0),
                   "auto")
        Y = spmm(s["p32"], torch.from_numpy(X), 2.0, 0.5,
                 torch.from_numpy(Y0), "auto")
        Yj = jspmm(s["j32"], jnp.asarray(X), 2.0, 0.5, jnp.asarray(Y0),
                   "auto")
    else:
        y = spmv(s["p32"], torch.from_numpy(x), alpha=2.0, beta=0.5,
                 y=torch.from_numpy(y0), strategy="merge")
        yj = jspmv(s["j32"], jnp.asarray(x), alpha=2.0, beta=0.5,
                   y=jnp.asarray(y0), strategy="merge")
        Y = spmm(s["p32"], torch.from_numpy(X), alpha=2.0, beta=0.5,
                 Y=torch.from_numpy(Y0), strategy="row_split")
        Yj = jspmm(s["j32"], jnp.asarray(X), alpha=2.0, beta=0.5,
                   Y=jnp.asarray(Y0), strategy="row_split")
    A = np.abs(s["pcsr"].to_scipy())
    for got, want, v, w in ((y, yj, x, y0), (Y, Yj, X, Y0)):
        bound = 16 * U * (2 * A @ np.abs(v) + np.abs(w)) + 1e-30
        np.testing.assert_array_less(
            np.abs(got.numpy() - np.asarray(want)), bound)


def test_unknown_strategy_raises_in_both():
    s = _spd()
    b = _rhs(s["pcsr"].num_rows, 0, 12)
    with pytest.raises(ValueError):
        jspmv(s["j32"], jnp.asarray(b), strategy="fastest")
    for call in (lambda: spmv(s["p32"], torch.from_numpy(b),
                              strategy="fastest"),
                 lambda: cg_solve(s["p32"], torch.from_numpy(b),
                                  strategy="fastest"),
                 lambda: cg_solve_multi(s["p32"],
                                        torch.from_numpy(b[:, None]),
                                        strategy="fastest")):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_csr_runs_the_reference_product(dtype):
    """A host CsrMatrix (float64 values) to ``spmv``/``spmm``/
    ``cg_solve``/``cg_solve_multi``: the reference product on the
    vector's device in the vector's type; JAX's result on the host
    matrix in that type (JAX's CG takes no float32 vector against
    float64 host values under x64)."""
    s = _spd()
    n = s["pcsr"].num_rows
    jc = s["jcsr"]
    jh = JCsr(jc.num_rows, jc.num_cols, jc.row_offsets, jc.col_indices,
              np.asarray(jc.values).astype(dtype))
    x = _rhs(n, 0, 13, dtype)
    X = _rhs(n, 3, 14, dtype)
    y = spmv(s["pcsr"], torch.from_numpy(x))
    Y = spmm(s["pcsr"], torch.from_numpy(X))
    assert y.dtype == _torch_dtype(dtype) and Y.dtype == y.dtype
    tol = 8 * (U if dtype == np.float32 else 2.0 ** -53)
    A = np.abs(s["pcsr"].to_scipy())
    np.testing.assert_array_less(
        np.abs(y.numpy() - np.asarray(jspmv(jh, jnp.asarray(x)))),
        tol * (A @ np.abs(x)) + 1e-300)
    np.testing.assert_array_less(
        np.abs(Y.numpy() - np.asarray(jspmm(jh, jnp.asarray(X)))),
        tol * (A @ np.abs(X)) + 1e-300)
    r = cg_solve(s["pcsr"], torch.from_numpy(x), 500, 1e-5)
    j = jcg.cg_solve(jh, jnp.asarray(x), 500, 1e-5)
    assert abs(_iters(r) - _iters(j)) <= 1 and r.converged == bool(
        j.converged)
    rm = cg_solve_multi(s["pcsr"], torch.from_numpy(X), 500, 1e-5)
    jm = jcg.cg_solve_multi(jh, jnp.asarray(X), 500, 1e-5)
    assert abs(_iters(rm) - _iters(jm)) <= 1
    assert rm.converged.tolist() == _conv(jm)
    assert r.x.dtype == _torch_dtype(dtype)


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_product_adds_in_csr_order(dtype, L):
    """The CPU reference product (``index_add_``) adds each row's
    products from +0 in CSR order, each product and sum rounded apart:
    the order KR keeps on the card, so the card's bits are these."""
    from tpusparse_torch.ops.reference import csr_matmat, csr_matvec

    csr = gen.make_rmat(9, edge_factor=8).to_csr()
    C = csr.to("cpu", dtype)
    X = _rhs(csr.num_cols, L, 15, dtype)
    ro, ci = np.asarray(csr.row_offsets), np.asarray(csr.col_indices)
    v = C.values.numpy()
    want = np.zeros((csr.num_rows, L), dtype)
    for i in range(csr.num_rows):
        acc = np.zeros(L, dtype)
        for p in range(ro[i], ro[i + 1]):
            acc = (acc + (v[p] * X[ci[p]]).astype(dtype)).astype(dtype)
        want[i] = acc
    args = (C.num_rows, C.row_offsets, C.col_indices, C.values)
    got = (csr_matvec(*args, torch.from_numpy(X[:, 0]))[:, None] if L == 1
           else csr_matmat(*args, torch.from_numpy(X)))
    np.testing.assert_array_equal(got.numpy(), want)
