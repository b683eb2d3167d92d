"""The port's preconditioners and preconditioned solvers against the JAX
package: IC(0), the triangular solves, SPAI, PCG and SPAI-CG.

Both packages get the same host matrices and numpy-seeded right-hand
sides. On the JAX side the solvers run on its ``strategy='reference'``
plans (XLA products, no interpret-mode kernels), so the comparison is of
the algorithms: the port runs its AUTO plans' plain versions.

  * IC(0): the port's Python factorization equals the JAX package's to
    1e-13 relative, entry by entry (the sandbox's JAX package uses its
    native C++ loop; both compute the same sums in the same order);
  * triangular solves: 1e-12 relative to the JAX host oracles and its
    level-scheduled solver, in float64;
  * SPAI: M within 1e-10 of the JAX package's (batched QR in float64 on
    both sides, by different LAPACK paths);
  * PCG and SPAI-CG: the JAX package's iterations +-1 and its residual
    history within 1e-3 relative; on a reordered plan the same call in
    both packages (the preconditioner in the caller's order), and a
    preconditioner of the permuted matrix that declares the plan's order.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pathlib import Path

import tpusparse.precond.spai as jspai
from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.precond import trisolve as jtri
from tpusparse.precond.ic0 import ic0_factorize as jic0
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.solvers.pcg import make_exact_ic0_preconditioner as jexact
from tpusparse.solvers.pcg import make_ic0_preconditioner as jmake_ic0
from tpusparse.solvers.pcg import pcg_solve_multi as jpcg
from tpusparse.solvers.spai_cg import spai_cg_solve_multi as jspai_cg
from tpusparse_torch import (
    CsrMatrix,
    ic0_factorize,
    make_exact_ic0_preconditioner,
    make_ic0_preconditioner,
    pcg_solve_multi,
    plan_kind,
    plan_matrix,
    spai_cg_solve_multi,
    spai_inverse,
)
from tpusparse_torch.bench.models import cg_flops, pcg_flops, permute_bytes
from tpusparse_torch.precond import ic0, spai, trisolve

ROOT = Path(__file__).resolve().parent.parent


def _port(j) -> CsrMatrix:
    return CsrMatrix(j.num_rows, j.num_cols, np.asarray(j.row_offsets),
                     np.asarray(j.col_indices), np.asarray(j.values))


def _indefinite():
    """A 2 x 2 indefinite matrix: IC(0) needs shift retries."""
    from tpusparse.formats.csr import CsrMatrix as JCsr
    import scipy.sparse as sp

    return JCsr.from_scipy(sp.csr_matrix(np.array([[1.0, 2.0],
                                                   [2.0, 1.0]])))


FIXTURES = {
    "lap2d-24": lambda: jgen.make_laplacian_grid2d(24).to_csr(),
    "lap3d-8": lambda: jgen.make_laplacian_grid3d(8).to_csr(),
    "gr_30_30": lambda: jread_market(ROOT / "data/real/gr_30_30.mtx"
                                     ).to_csr(),
    "fem2d-800": lambda: jgen.make_fem2d(800, seed=1).to_csr(),
    "indefinite-2": _indefinite,
}


@pytest.fixture(scope="module")
def factors():
    """name -> (JAX host CSR, JAX IC(0) factor), built once."""
    return {k: (f(), jic0(f())) for k, f in FIXTURES.items()}


def _rel_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-300))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_ic0_python_equals_jax(factors, name):
    j, jL = factors[name]
    L = ic0_factorize(_port(j), impl="python")
    np.testing.assert_array_equal(L.row_offsets, np.asarray(jL.row_offsets))
    np.testing.assert_array_equal(L.col_indices, np.asarray(jL.col_indices))
    assert L.values.dtype == np.float64
    _rel_close(L.values, jL.values, 1e-13)


def test_ic0_shift_retry_and_failure():
    """The indefinite fixture needs a shift; with one attempt it fails as
    the JAX package's does, and an unknown impl raises."""
    c = _port(_indefinite())
    L1 = ic0_factorize(c, impl="python")
    assert np.all(np.isfinite(L1.values)) and L1.values[0] > 1.0
    with pytest.raises(RuntimeError, match="after 1 diagonal-shift"):
        ic0_factorize(c, max_attempts=1, impl="python")
    with pytest.raises(ValueError):
        ic0_factorize(c, impl="fortran")
    assert ic0.default_impl() == "python"   # no card here


@pytest.mark.parametrize("name", ["lap2d-24", "gr_30_30", "fem2d-800"])
def test_trisolves_match_jax_oracles_and_level_solver(factors, name):
    j, jL = factors[name]
    L = _port(jL)
    b = np.random.default_rng(4).standard_normal((j.num_rows, 3))
    fwd = trisolve.forward_solve_host(L, b)
    bwd = trisolve.backward_solve_host(L, b)
    np.testing.assert_allclose(fwd, jtri.forward_solve_host(jL, b),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(bwd, jtri.backward_solve_host(jL, b),
                               rtol=1e-12, atol=0)
    jlo, jup = jtri.level_trisolve_lower(jL), jtri.level_trisolve_upper(jL)
    lo = trisolve.level_trisolve_lower(L, device="cpu", impl="python")
    up = trisolve.level_trisolve_upper(L, device="cpu", impl="python")
    assert (lo.nlev, up.nlev) == (jlo.nlev, jup.nlev)
    bt = torch.from_numpy(b)
    for solver, jsolver, oracle in ((lo, jlo, fwd), (up, jup, bwd)):
        x = solver.solve(bt).numpy()
        scale = np.abs(oracle).max()
        assert np.abs(x - oracle).max() <= 1e-12 * scale
        xj = np.asarray(jsolver.solve(jnp.asarray(b)))
        assert np.abs(x - xj).max() <= 1e-12 * scale
        x1 = solver.solve(bt[:, 0]).numpy()
        assert x1.shape == (j.num_rows,)
        assert np.abs(x1 - oracle[:, 0]).max() <= 1e-12 * scale


@pytest.mark.parametrize("name", ["lap2d-24", "fem2d-800"])
def test_dependency_levels_equal_jax(factors, name):
    _, jL = factors[name]
    for T, lower in ((jL, True), (jL.transpose(), False)):
        ro, ci = np.asarray(T.row_offsets), np.asarray(T.col_indices)
        np.testing.assert_array_equal(
            trisolve._dependency_levels(ro, ci, T.num_rows, lower, "python"),
            jtri._dependency_levels(ro, ci, T.num_rows, lower))


@pytest.mark.parametrize("name", ["lap2d-24", "fem2d-800"])
def test_jacobi_sweeps_at_nilpotency_depth_are_exact(factors, name):
    """As many sweeps as the factor has levels give the exact solve, in
    float64, on the AUTO plans of the strict triangles (plain versions);
    the port's sweeps equal the JAX package's on its reference plans."""
    j, jL = factors[name]
    L = _port(jL)
    b = np.random.default_rng(6).standard_normal((j.num_rows, 2))
    depth = trisolve.level_trisolve_lower(L, "cpu", "python").nlev
    lo = trisolve.jacobi_trisolve_lower(L, sweeps=depth, num_rhs=2,
                                        device="cpu")
    up = trisolve.jacobi_trisolve_upper(L, sweeps=depth, num_rhs=2,
                                        device="cpu")
    fwd = trisolve.forward_solve_host(L, b)
    bwd = trisolve.backward_solve_host(L, b)
    for solver, oracle in ((lo, fwd), (up, bwd)):
        x = solver.solve(torch.from_numpy(b)).numpy()
        assert np.abs(x - oracle).max() <= 1e-12 * np.abs(oracle).max()
    # two sweeps (the PCG default): the same truncated operator as JAX
    jref = (lambda s: jplan(s, "reference"))
    for port, jax_ in ((trisolve.jacobi_trisolve_lower,
                        jtri.jacobi_trisolve_lower),
                       (trisolve.jacobi_trisolve_upper,
                        jtri.jacobi_trisolve_upper)):
        x = port(L, sweeps=2, num_rhs=2, device="cpu").solve(
            torch.from_numpy(b)).numpy()
        xj = np.asarray(jax_(jL, sweeps=2, to_plan=jref).solve(
            jnp.asarray(b)))
        assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("name", ["lap2d-24", "gr_30_30"])
def test_spai_equals_jax(factors, name, batched):
    j, _ = factors[name]
    M = spai_inverse(_port(j), batched=batched, device="cpu")
    jM = jspai.spai_inverse(j, batched=batched)
    np.testing.assert_array_equal(M.row_offsets, np.asarray(jM.row_offsets))
    np.testing.assert_array_equal(M.col_indices, np.asarray(jM.col_indices))
    assert np.abs(M.values - np.asarray(jM.values)).max() \
        <= 1e-10 * np.abs(np.asarray(jM.values)).max()


def _hub():
    """A random SPD matrix with one dense row and column (the JAX
    package's hub-guard fixture)."""
    from tpusparse.formats.csr import CsrMatrix as JCsr

    S = jgen.make_random_spd(400, row_nnz=6, seed=5).to_scipy().tolil()
    S[:, 0] = 1.0
    S[0, :] = 1.0
    return JCsr.from_scipy(S.tocsr())


def test_spai_cap_pattern_equals_jax():
    j = _hub()
    for cap in (4, 16):
        P = spai._cap_pattern(_port(j), cap)
        jP = jspai._cap_pattern(j, cap)
        for a, b in ((P.row_offsets, jP.row_offsets),
                     (P.col_indices, jP.col_indices), (P.values, jP.values)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_spai_auto_guard_warns(monkeypatch):
    c = _port(_hub())
    monkeypatch.setattr(spai, "SPAI_GUARD_CELLS", 1 << 14)
    with pytest.warns(UserWarning, match="symmetric cap 16"):
        M = spai_inverse(c, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        M_ref = spai_inverse(c, cap=None, device="cpu")
    assert M.nnz < M_ref.nnz
    Ms = M.to_scipy()
    assert abs(Ms - Ms.T).max() < 1e-12
    monkeypatch.setattr(spai, "SPAI_GUARD_CELLS", 1 << 62)
    assert spai_inverse(c, device="cpu").nnz == M_ref.nnz


def _rhs(n, L, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal((n, L)).astype(dtype)


def _check_parity(res, jres, what):
    it, jit = res.iterations, int(jres.iterations)
    assert bool(res.converged.all()) and bool(np.all(jres.converged)), what
    assert abs(it - jit) <= 1, f"{what}: {it} vs JAX {jit}"
    k = min(it, jit)
    h, jh = res.history[:k].double().numpy(), np.asarray(jres.history)[:k]
    assert np.all(np.abs(h - jh) <= 1e-3 * np.abs(jh)), what


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("name", ["lap2d-24", "lap3d-8", "gr_30_30"])
def test_pcg_ic0_iterations_match_jax(factors, name, L, dtype):
    """PCG with two Jacobi sweeps. The port's AUTO plans are pure DIA on
    these stencils, so its PCG keeps (L, n) state behind the
    preconditioner's transposes; the JAX side runs its generic path."""
    j, jL = factors[name]
    c = _port(j)
    B = _rhs(c.num_rows, L, dtype, seed=L)
    jref = (lambda s: jplan(s, "reference", dtype=dtype))
    jres = jpcg(jplan(j, "reference", dtype=dtype), jnp.asarray(B),
                jmake_ic0(jL, sweeps=2, to_plan=jref, dtype=dtype))
    A = plan_matrix(c, "auto", dtype=dtype, L=L, device="cpu")
    prec = make_ic0_preconditioner(_port(jL), sweeps=2, num_rhs=L,
                                   dtype=dtype, device="cpu")
    res = pcg_solve_multi(A, torch.from_numpy(B), prec)
    assert res.x.dtype == torch.from_numpy(B).dtype
    _check_parity(res, jres, f"pcg {name} L={L} {dtype.__name__}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("name", ["lap2d-24", "lap3d-8", "gr_30_30"])
def test_spai_cg_iterations_match_jax(factors, name, L, dtype):
    j, _ = factors[name]
    c = _port(j)
    B = _rhs(c.num_rows, L, dtype, seed=10 + L)
    jM = jspai.spai_inverse(j)
    jres = jspai_cg(jplan(j, "reference", dtype=dtype),
                    jplan(jM.astype(dtype), "reference", dtype=dtype),
                    jnp.asarray(B))
    M = spai_inverse(c, device="cpu")
    res = spai_cg_solve_multi(
        plan_matrix(c, "auto", dtype=dtype, L=L, device="cpu"),
        plan_matrix(M, "auto", dtype=dtype, L=L, device="cpu"),
        torch.from_numpy(B))
    _check_parity(res, jres, f"spai-cg {name} L={L} {dtype.__name__}")


def _scrambled_lap2d():
    """(JAX host CSR of a scrambled lap2d-24, the port's ReorderedPlan of
    it with RCM at L = 3 in float64, its permutation, the JAX host CSR in
    the plan's order)."""
    from tpusparse.ops.reorder import permute_symmetric as jpermute

    j = FIXTURES["lap2d-24"]()
    j = jpermute(j, np.random.default_rng(4).permutation(j.num_rows))
    A = plan_matrix(_port(j), "merge", dtype=np.float64, reorder="rcm", L=3,
                    device="cpu")
    assert plan_kind(A) == "rcm+merge"
    perm = A.perm.numpy()
    jp = jpermute(j, perm)
    Ap = A.permuted(_port(j))
    np.testing.assert_array_equal(Ap.row_offsets, np.asarray(jp.row_offsets))
    np.testing.assert_array_equal(Ap.col_indices, np.asarray(jp.col_indices))
    np.testing.assert_array_equal(Ap.values, np.asarray(jp.values))
    return j, A, perm, jp


def _check_original_order(res, c, B):
    """X came back in the original order: its float64 true residual on
    the unpermuted matrix is below 1e-4."""
    X = res.x.numpy()
    rel = np.linalg.norm(B - c.to_scipy() @ X, axis=0) / np.linalg.norm(
        B, axis=0)
    assert np.all(rel < 1e-4), rel


@pytest.mark.parametrize("exact", [False, True])
def test_pcg_generic_path_on_reordered_plan(exact):
    """PCG on a reordered plan runs in the permuted space (K6's plain
    version on B in and X out, the inner merge plan's plain version in
    between) with the IC(0) factor of ``A.permuted(csr)``, which declares
    the plan's order (``perm=A.perm``): held to the JAX package's PCG on
    the permuted matrix and the same factor (exact IC(0) to its exact,
    level-scheduled PCG). The fixture is a scrambled lap2d-24 (on fem2d
    the residual curve amplifies rounding, and two exact solves in
    different summation orders part by two iterations)."""
    j, A, perm, jp = _scrambled_lap2d()
    jL = jic0(jp)
    B = _rhs(j.num_rows, 3, np.float64, seed=7)
    if exact:
        prec = make_exact_ic0_preconditioner(_port(jL), device="cpu",
                                             impl="python", perm=A.perm)
        jprec = jexact(jL)
    else:
        prec = make_ic0_preconditioner(_port(jL), num_rhs=3, device="cpu",
                                       perm=A.perm)
        jprec = jmake_ic0(jL, to_plan=lambda s: jplan(s, "reference"))
    res = pcg_solve_multi(A, torch.from_numpy(B), prec)
    jres = jpcg(jplan(jp, "reference"), jnp.asarray(B[perm]), jprec)
    _check_parity(res, jres, f"pcg scrambled lap2d-24 exact={exact}")
    _check_original_order(res, _port(j), B)


def test_spai_cg_on_reordered_plan():
    """SPAI-CG on a reordered plan, with M the SPAI of ``A.permuted(csr)``
    declared in the plan's order: held to the JAX package's SPAI-CG on
    the permuted matrix."""
    j, A, perm, jp = _scrambled_lap2d()
    B = _rhs(j.num_rows, 3, np.float64, seed=8)
    M = spai_inverse(A.permuted(_port(j)), device="cpu")
    res = spai_cg_solve_multi(
        A, plan_matrix(M, "auto", dtype=np.float64, L=3, device="cpu"),
        torch.from_numpy(B), perm=A.perm)
    jM = jspai.spai_inverse(jp)
    jres = jspai_cg(jplan(jp, "reference"), jplan(jM, "reference"),
                    jnp.asarray(B[perm]))
    _check_parity(res, jres, "spai-cg scrambled lap2d-24")
    _check_original_order(res, _port(j), B)


def test_fem2d_float64_converges_in_the_permuted_space():
    """The A11 acceptance at a small size: fem2d in float64 with
    reorder='auto' (RCM fires), IC(0) of the permuted matrix, PCG on the
    reordered plan (in the permuted space, the solution permuted back);
    float64 true residual below 1e-4 at tol 1e-5, and fewer iterations
    than CG."""
    from tpusparse_torch import cg_solve_multi

    c = _port(jgen.make_fem2d(3000, seed=1).to_csr())
    A = plan_matrix(c, "auto", dtype=np.float64, reorder="auto", L=1,
                    device="cpu")
    assert A.order == "rcm"
    Lf = ic0_factorize(A.permuted(c), impl="python")
    prec = make_ic0_preconditioner(Lf, num_rhs=1, device="cpu", perm=A.perm)
    B = torch.from_numpy(_rhs(c.num_rows, 1, np.float64))
    res = pcg_solve_multi(A, B, prec, max_iters=5000)
    X = res.x.numpy()
    rel = np.linalg.norm(B.numpy() - c.to_scipy() @ X) / np.linalg.norm(B)
    assert bool(res.converged.all()) and rel < 1e-4
    # CG has not converged after as many iterations (it needs about 2000)
    cg = cg_solve_multi(A, B, max_iters=res.iterations)
    assert not bool(cg.converged.any())


@pytest.mark.parametrize("solver", ["pcg", "spai_cg"])
def test_reordered_plan_takes_the_jax_call(solver):
    """The JAX-style call on a reordered plan: the preconditioner built
    from the matrix as given (the caller's order), applied behind K6's
    plain version. The JAX package permutes around each product instead;
    both take the same iterations (28 for PCG on this fixture) and
    history."""
    j, A, perm, _ = _scrambled_lap2d()
    B = _rhs(j.num_rows, 3, np.float64, seed=7)
    jA = jplan(j, "reference", reorder="rcm")
    if solver == "pcg":
        jL = jic0(j)
        jres = jpcg(jA, jnp.asarray(B),
                    jmake_ic0(jL, to_plan=lambda s: jplan(s, "reference")))
        res = pcg_solve_multi(A, torch.from_numpy(B), make_ic0_preconditioner(
            _port(jL), num_rhs=3, device="cpu"))
        assert abs(int(jres.iterations) - 28) <= 1
    else:
        jM = jspai.spai_inverse(j)
        jres = jspai_cg(jA, jplan(jM, "reference"), jnp.asarray(B))
        M = spai_inverse(_port(j), device="cpu")
        res = spai_cg_solve_multi(A, plan_matrix(
            M, "auto", dtype=np.float64, L=3, device="cpu"),
            torch.from_numpy(B))
    _check_parity(res, jres, f"{solver} JAX call on a reordered plan")
    _check_original_order(res, _port(j), B)


def test_declared_order_must_be_the_plans():
    """A preconditioner that declares an order other than the plan's, or
    one on a solve that does not run in the permuted space, raises."""
    j, A, perm, _ = _scrambled_lap2d()
    c = _port(j)
    B = torch.from_numpy(_rhs(j.num_rows, 3, np.float64, seed=7))
    Lf = ic0_factorize(A.permuted(c), impl="python")
    ok = make_ic0_preconditioner(Lf, num_rhs=3, device="cpu",
                                 perm=perm.copy())
    assert bool(pcg_solve_multi(A, B, ok).converged.all())
    wrong = make_ic0_preconditioner(Lf, num_rhs=3, device="cpu",
                                    perm=np.arange(j.num_rows))
    with pytest.raises(ValueError, match="another order"):
        pcg_solve_multi(A, B, wrong)
    with pytest.raises(ValueError, match="permuted space"):
        pcg_solve_multi(A, B, ok, matmat=lambda V: V)
    A0 = plan_matrix(c, "merge", dtype=np.float64, L=3, device="cpu")
    with pytest.raises(ValueError, match="permuted space"):
        pcg_solve_multi(A0, B, ok)
    M = plan_matrix(spai_inverse(c, device="cpu"), "auto", dtype=np.float64,
                    L=3, device="cpu")
    with pytest.raises(ValueError, match="another order"):
        spai_cg_solve_multi(A, M, B, perm=np.arange(j.num_rows))


def test_plain_callable_declares_its_order_by_keyword():
    """``pcg_solve_multi(..., perm=A.perm)`` declares the plan's order for
    any callable: a lambda around the IC(0) preconditioner of
    ``A.permuted(csr)`` gives the very solve that its ``perm`` field
    gives, and a wrong keyword raises."""
    j, A, perm, _ = _scrambled_lap2d()
    B = torch.from_numpy(_rhs(j.num_rows, 3, np.float64, seed=7))
    Lf = ic0_factorize(A.permuted(_port(j)), impl="python")
    prec = make_ic0_preconditioner(Lf, num_rhs=3, device="cpu", perm=A.perm)
    res = pcg_solve_multi(A, B, prec)
    res_kw = pcg_solve_multi(A, B, lambda R: prec(R), perm=A.perm)
    assert res_kw.iterations == res.iterations
    assert torch.equal(res_kw.x, res.x)
    with pytest.raises(ValueError, match="another order"):
        pcg_solve_multi(A, B, lambda R: prec(R),
                        perm=np.arange(j.num_rows))


def test_pcg_with_matmat_takes_the_jax_route():
    """``matmat`` on a reordered plan: no permuted-space solve, the
    preconditioner in the caller's order, as in the JAX package."""
    from tpusparse.ops.spmv import spmm as jspmm
    from tpusparse_torch import spmm

    j, A, _, _ = _scrambled_lap2d()
    jL = jic0(j)
    B = _rhs(j.num_rows, 3, np.float64, seed=7)
    jA = jplan(j, "reference")
    jres = jpcg(jA, jnp.asarray(B),
                jmake_ic0(jL, to_plan=lambda s: jplan(s, "reference")),
                matmat=lambda V: jspmm(jA, V))
    C = plan_matrix(_port(j), "merge", dtype=np.float64, L=3, device="cpu")
    res = pcg_solve_multi(A, torch.from_numpy(B), make_ic0_preconditioner(
        _port(jL), num_rhs=3, device="cpu"), matmat=lambda V: spmm(C, V))
    _check_parity(res, jres, "pcg with matmat")


def test_pcg_and_permute_models():
    assert permute_bytes(10, 1) == 120 and permute_bytes(10, 16, 8) == 2600
    base = cg_flops(100, 10, 4, 3)
    assert pcg_flops(100, 10, 4, 3, 50) == base + 2 * 50 * 4 * 3
    assert pcg_flops(100, 10, 4, 3, 50, sweeps=2) == \
        base + 2 * 2 * 2 * 50 * 4 * 3
