"""The port's reordering (``ops/reorder.py``) and the plain version of
its permutation kernel K6 against the JAX package.

Both packages get the same host matrices (the JAX generators' arrays, or
the port's, which ``test_torch_host.py`` holds equal) and numpy-seeded
inputs. The JAX permute kernel B13 runs in interpret mode on the CPU, as
the JAX package's own tests run it.

  * orderings and permuted matrices: equal arrays;
  * K6's plain version: equal to B13 bit for bit (a permutation does no
    arithmetic);
  * ``ReorderedPlan`` products: the port's inner plan is a merge plan,
    so its ``spmv``/``spmm`` are within (nnz_i + 2) u (|A||x|)_i of the
    float64 golden and normwise within 1e-5 of the JAX ReorderedPlan;
  * CG on a reordered plan: the JAX package's iterations +-1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.io import generators as jgen
from tpusparse.kernels.permute import build_permute_plan as jbuild_permute
from tpusparse.kernels.permute import permute_apply as jpermute_apply
from tpusparse.ops import reorder as jreorder
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse.solvers.cg import cg_solve as jcg_solve
from tpusparse.utils import native as jnative
from tpusparse_torch import (
    CsrMatrix,
    ReorderedPlan,
    cg_solve,
    cg_solve_multi,
    cg_solve_refined,
    plan_dia_bf16,
    plan_dtype,
    plan_kind,
    plan_matrix,
    plan_reorder,
    plan_semantics,
    spmm,
    spmv,
)
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import permute
from tpusparse_torch.ops import reorder
from tpusparse_torch.ops.reference import spmv_numpy
from tpusparse_torch.utils.carry import plan_from_arrays

U = 2.0 ** -24


def _port(j) -> CsrMatrix:
    """The port's host CSR of a JAX host CSR (the same arrays)."""
    return CsrMatrix(j.num_rows, j.num_cols, np.asarray(j.row_offsets),
                     np.asarray(j.col_indices), np.asarray(j.values))


def _scrambled(jcsr, seed=3):
    return jreorder.permute_symmetric(
        jcsr, np.random.default_rng(seed).permutation(jcsr.num_rows))


FIXTURES = {
    "lap2d-40": lambda: jgen.make_laplacian_grid2d(40).to_csr(),
    "lap2d-40-scrambled":
        lambda: _scrambled(jgen.make_laplacian_grid2d(40).to_csr()),
    "lap3d-12-scrambled":
        lambda: _scrambled(jgen.make_laplacian_grid3d(12).to_csr()),
    "fem2d-3000": lambda: jgen.make_fem2d(3000, seed=1).to_csr(),
    "wheel-2000": lambda: jgen.make_wheel(2000).to_csr(),
    "rmat-11-ef8": lambda: jgen.make_rmat(11, edge_factor=8,
                                          seed=1).to_csr(),
    "rmat-12-ef4": lambda: jgen.make_rmat(12, edge_factor=4,
                                          seed=1).to_csr(),
    "rmat-14-ef4": lambda: jgen.make_rmat(14, edge_factor=4,
                                          seed=1).to_csr(),
    "rmat-16-ef4": lambda: jgen.make_rmat(16, edge_factor=4,
                                          seed=1).to_csr(),
}
# where the JAX package's 'auto' reorders through its secondary
# candidates, ranked by the TPU merge-tile score (not ported): it picks
# the degree order there when its native library scores them, the port
# keeps the native order
AUTO_DIVERGES = {"rmat-14-ef4", "rmat-16-ef4"}


@pytest.mark.parametrize("name", ["lap2d-40-scrambled", "fem2d-3000",
                                  "rmat-11-ef8", "wheel-2000"])
def test_orderings_and_permuted_matrix_equal_jax(name):
    j = FIXTURES[name]()
    c = _port(j)
    rcm = reorder.rcm_order(c)
    deg = reorder.degree_order(c)
    np.testing.assert_array_equal(rcm, jreorder.rcm_order(j))
    np.testing.assert_array_equal(deg, jreorder.degree_order(j))
    assert reorder.bandwidth(c) == jreorder.bandwidth(j)
    for p in (rcm, deg, np.random.default_rng(1).permutation(c.num_rows)):
        mp, jp = reorder.permute_symmetric(c, p), jreorder.permute_symmetric(
            j, p)
        for a, b in ((mp.row_offsets, jp.row_offsets),
                     (mp.col_indices, jp.col_indices),
                     (mp.values, jp.values)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert reorder.bandwidth(c, p) == jreorder.bandwidth(jp)
    assert reorder._degree_concentration(c) == \
        jreorder._degree_concentration(j)
    assert reorder._dia_eligible(c) == jreorder._dia_eligible(j)


@pytest.mark.parametrize("dtype,n,kind", [
    (np.float32, 1000, "random"), (np.int32, 5000, "reverse"),
    (np.int32, 1024, "identity")])
def test_k6_plain_equals_b13_bitwise(dtype, n, kind):
    """B13 in interpret mode costs seconds per shape: three cases, both
    of its types, a length below, at and above its 1024-element tile."""
    rng = np.random.default_rng(n)
    perm = {"random": rng.permutation(n), "reverse": np.arange(n)[::-1],
            "identity": np.arange(n)}[kind]
    x = (rng.standard_normal(n).astype(np.float32) if dtype == np.float32
         else rng.integers(-2**30, 2**30, n).astype(np.int32))
    y_jax = np.asarray(jpermute_apply(jbuild_permute(perm), jnp.asarray(x)))
    p = permute.build_permute_plan(perm, "cpu")
    y = permute.permute_apply(p, torch.from_numpy(x)).numpy()
    assert y.dtype == x.dtype
    np.testing.assert_array_equal(y.view(np.int32), y_jax.view(np.int32))


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_k6_plain_blocks_and_float64(dtype, L):
    """The port takes what B13 does not: float64 and (n, L) blocks."""
    rng = np.random.default_rng(L)
    n = 777
    perm = rng.permutation(n)
    X = (rng.standard_normal((n, L)) * 1e3).astype(dtype)
    p = permute.build_permute_plan(perm, "cpu")
    Y = permute.permute_apply(p, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(Y, X[perm])
    np.testing.assert_array_equal(
        permute.permute_apply(p, torch.from_numpy(X[:, 0].copy())).numpy(),
        X[perm, 0])


def test_k6_validation():
    perm = np.random.default_rng(7).permutation(600)
    p = permute.build_permute_plan(perm, "cpu")
    with pytest.raises(ValueError, match="rows but the plan permutes 600"):
        permute.permute_apply(p, torch.zeros(601))
    bad = perm.copy()
    bad[0] = 600
    with pytest.raises(ValueError, match=r"\[0, 600\)"):
        permute.build_permute_plan(bad, "cpu")
    bad[0] = -1
    with pytest.raises(ValueError):
        permute.build_permute_plan(bad, "cpu")
    with pytest.raises(TypeError):
        permute.permute_apply(p, torch.zeros(600, dtype=torch.float16))
    with pytest.raises(TypeError):
        permute.permute_apply(p.long(), torch.zeros(600))
    assert permute.permute_apply(permute.build_permute_plan(
        np.zeros(0, np.int64), "cpu"), torch.zeros(0)).shape == (0,)


@pytest.mark.parametrize("order", ["rcm", "degree"])
def test_reordered_spmv_spmm_match_jax(order):
    """Against the float64 golden, and against the JAX ReorderedPlan
    (its permutations through B13 in interpret mode; its inner plan the
    reference product, as the JAX merge kernels cost seconds to compile
    in interpret mode and ``test_torch_merge.py`` holds K2 and K3 to
    them)."""
    j = _scrambled(jgen.make_laplacian_grid2d(32).to_csr())
    c = _port(j)
    A = plan_matrix(c, "merge", reorder=order, L=8, device="cpu",
                    dtype=np.float32)
    JA = jplan(j, "reference", dtype=np.float32, L=8, reorder=order)
    assert isinstance(A, ReorderedPlan) and A.order == order
    assert plan_kind(A) == f"{order}+merge" and plan_semantics(A) == "f32"
    assert plan_dtype(A) == torch.float32
    np.testing.assert_array_equal(A.perm.numpy(), np.asarray(JA.perm))
    np.testing.assert_array_equal(A.inv_perm.numpy(),
                                  np.asarray(JA.inv_perm))
    rng = np.random.default_rng(11)
    x = rng.standard_normal(c.num_cols).astype(np.float32)
    X = rng.standard_normal((c.num_cols, 8)).astype(np.float32)
    y0 = rng.standard_normal(c.num_rows).astype(np.float32)
    S = c.to_scipy()
    absS = abs(S)
    nnz_i = np.diff(np.asarray(c.row_offsets))
    for alpha, beta in ((1.0, 0.0), (2.0, 0.5)):
        y = spmv(A, torch.from_numpy(x), alpha=alpha, beta=beta,
                 y=torch.from_numpy(y0)).numpy()
        yj = np.asarray(jspmv(JA, jnp.asarray(x), alpha=alpha, beta=beta,
                              y=jnp.asarray(y0)))
        ax = abs(alpha) * (absS @ np.abs(x.astype(np.float64))) \
            + abs(beta) * np.abs(y0)
        gold = alpha * spmv_numpy(c, x.astype(np.float64)) + beta * y0
        assert np.all(np.abs(y - gold) <= (nnz_i + 4) * U * ax)
        assert np.abs(y - yj).max() <= 1e-5 * ax.max()
    Y = spmm(A, torch.from_numpy(X)).numpy()
    Yj = np.asarray(jspmm(JA, jnp.asarray(X)))
    AX = absS @ np.abs(X.astype(np.float64))
    assert np.all(np.abs(Y - S @ X.astype(np.float64))
                  <= (nnz_i[:, None] + 2) * U * AX)
    assert np.abs(Y - Yj).max() <= 1e-5 * AX.max()


def test_reordered_float64_plan():
    """A float64 reordered plan permutes float64 vectors exactly and
    computes in float64 on its inner plan (2(nnz_i + 2)u of the
    unpermuted float64 reference plan); a float32 x is cast first."""
    c = _port(_scrambled(jgen.make_laplacian_grid2d(40).to_csr()))
    A = plan_matrix(c, "auto", dtype=np.float64, reorder="rcm", L=4,
                    device="cpu")
    R = plan_matrix(c, "reference", dtype=np.float64, device="cpu")
    assert plan_semantics(A) == "ieee-f64"
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((c.num_cols, 4)))
    AX = torch.from_numpy(abs(c.to_scipy()) @ np.abs(X.numpy()))
    nnz_i = torch.from_numpy(np.diff(np.asarray(c.row_offsets)))[:, None]
    bound = 2 * (nnz_i + 2) * 2.0 ** -53 * AX
    Y = spmm(A, X)
    assert Y.dtype == torch.float64
    assert torch.all((Y - spmm(R, X)).abs() <= bound)
    y = spmv(A, X[:, 0].float())
    assert y.dtype == torch.float64
    assert torch.all((y - spmv(R, X[:, 0].float().double())).abs()
                     <= bound[:, 0])


def _jax_primary_gate_fires(j) -> bool:
    """The JAX package's primary 'auto' gate, from its public pieces:
    RCM's permuted bandwidth plus ``RCM_SLACK`` is at most ``RCM_GAIN``
    of the original's."""
    inv = np.argsort(jreorder.rcm_order(j))
    ro = np.asarray(j.row_offsets)
    ci = np.asarray(j.col_indices).astype(np.int64)
    rows = np.repeat(np.arange(j.num_rows, dtype=np.int64), np.diff(ro))
    d_orig = int(np.abs(rows - ci).max())
    d_perm = int(np.abs(inv[rows] - inv[ci]).max())
    return d_perm + jreorder.RCM_SLACK <= jreorder.RCM_GAIN * d_orig


def _jax_scores_natively() -> bool:
    """Whether the JAX package's scored 'auto' candidates run on its
    native library in this process; without it they fall back to a
    two-candidate numpy grid whose verdict differs."""
    return (os.environ.get("TPUSPARSE_NO_NATIVE") != "1"
            and jnative.available())


@pytest.mark.parametrize("name", list(FIXTURES))
def test_auto_agrees_with_jax_on_the_primary_gate(name):
    j = FIXTURES[name]()
    c = _port(j)
    A = plan_matrix(c, "reference", reorder="auto", device="cpu",
                    dtype=np.float32)
    JA = jplan(j, "reference", dtype=np.float32, reorder="auto")
    port = A.order if isinstance(A, ReorderedPlan) else None
    jax_ = JA.order if isinstance(JA, jreorder.ReorderedPlan) else None
    if name in AUTO_DIVERGES:
        # the port keeps only the primary gate, and it does not fire
        # here; JAX's degree prefilter holds, with the port's pieces
        # equal to JAX's
        assert not _jax_primary_gate_fires(j)
        conc = jreorder._degree_concentration(j)
        assert conc >= jreorder.DEGREE_TOP_FRAC
        assert not jreorder._dia_eligible(j)
        assert reorder._degree_concentration(c) == conc
        assert reorder._dia_eligible(c) == jreorder._dia_eligible(j)
        assert port is None
        if _jax_scores_natively():
            # JAX's scored choice, on its native candidate grid
            assert jax_ == "degree"
    else:
        assert port == jax_


def test_plan_reorder_unsquare_and_empty_plan_unpermuted():
    rect = CsrMatrix(3, 4, np.array([0, 1, 2, 3]), np.array([0, 1, 3]),
                     np.ones(3))
    empty = CsrMatrix(3, 3, np.zeros(4, np.int32), np.zeros(0, np.int32),
                      np.zeros(0))
    for c in (rect, empty):
        assert not isinstance(plan_reorder(c, "merge", device="cpu",
                                           dtype=np.float32),
                              ReorderedPlan)
    with pytest.raises(ValueError):
        plan_reorder(empty, order="nested", device="cpu", dtype=np.float32)


def test_cg_iteration_parity_under_reorder():
    """The JAX package's ``test_cg_iteration_parity_under_reorder`` case
    (scrambled lap2d-24, merge, RCM): the port's CG on its reordered plan
    takes JAX's iterations +-1, and the unpermuted solve's."""
    j = jgen.make_laplacian_grid2d(24).to_csr()
    j = jreorder.permute_symmetric(
        j, np.random.default_rng(3).permutation(j.num_rows))
    c = _port(j)
    b = np.random.default_rng(42).standard_normal(c.num_rows).astype(
        np.float32)
    JA = jreorder.plan_reorder(j, strategy="merge", dtype=np.float32,
                               order="rcm")
    rj = jcg_solve(JA, jnp.asarray(b), max_iters=2000, tolerance=1e-5)
    A = plan_reorder(c, "merge", order="rcm", device="cpu", dtype=np.float32)
    r = cg_solve(A, torch.from_numpy(b), max_iters=2000, tolerance=1e-5)
    r0 = cg_solve(plan_matrix(c, "merge", device="cpu",
                              dtype=np.float32), torch.from_numpy(b),
                  max_iters=2000, tolerance=1e-5)
    assert r.converged and abs(r.iterations - int(rj.iterations)) <= 1
    assert abs(r.iterations - r0.iterations) <= 1
    rel = np.linalg.norm(b - c.to_scipy() @ r.x.double().numpy()) \
        / np.linalg.norm(b)
    assert rel < 1e-4


def test_cg_multi_and_refined_on_reordered_plans():
    """``cg_solve_multi`` solves in the permuted space on a pure DIA
    inner plan ((L, n) state) and returns original-order solutions; the
    float64 refinement takes reordered plans through the dispatch."""
    lap = gen.make_laplacian_grid2d(24).to_csr()
    p = np.random.default_rng(9).permutation(lap.num_rows)
    c = reorder.permute_symmetric(lap, p)
    # the permutation argsort(p) restores the band: a reordered plan of
    # the scrambled matrix whose inner plan is pure masked DIA
    A = ReorderedPlan(c.num_rows, c.num_cols, c.nnz,
                      plan_matrix(lap, "dia", L=4, device="cpu",
                                  dtype=np.float32),
                      permute.build_permute_plan(np.argsort(p), "cpu"),
                      permute.build_permute_plan(p, "cpu"))
    assert plan_kind(A) == "rcm+dia"
    B = np.random.default_rng(5).standard_normal((c.num_rows, 4))
    res = cg_solve_multi(A, torch.from_numpy(B.astype(np.float32)))
    assert bool(res.converged.all())
    rel = np.linalg.norm(B - c.to_scipy() @ res.x.double().numpy(),
                         axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-4
    # a bf16-plane inner plan computes on float32 vectors
    with pytest.warns(UserWarning, match="constant-coefficient"):
        inner = plan_dia_bf16(lap, device="cpu")
    Ab = ReorderedPlan(c.num_rows, c.num_cols, c.nnz, inner, A.perm,
                       A.inv_perm)
    x = torch.from_numpy(B[:, 0])
    y = spmv(Ab, x)
    assert y.dtype == torch.float32
    assert torch.equal(y, spmv(Ab.inner, x.float()[A.perm])[A.inv_perm])
    A32 = plan_matrix(c, "merge", reorder="rcm", device="cpu",
                      dtype=np.float32)
    A64 = plan_matrix(c, "merge", dtype=np.float64, reorder="rcm",
                      device="cpu")
    rr = cg_solve_refined(A32, A64, torch.from_numpy(B[:, 0]))
    rel = np.linalg.norm(B[:, 0] - c.to_scipy() @ rr.x.numpy()) \
        / np.linalg.norm(B[:, 0])
    assert rel < 1e-11


def test_carry_reordered_kind():
    j = _scrambled(jgen.make_laplacian_grid2d(32).to_csr())
    JA = jreorder.plan_reorder(j, strategy="reference", dtype=np.float32,
                               order="rcm")
    inner = JA.inner
    A = plan_from_arrays("reordered", {
        "shape": (JA.num_rows, JA.num_cols), "nnz": JA.nnz,
        "order": JA.order, "perm": np.asarray(JA.perm),
        "inv_perm": np.asarray(JA.inv_perm), "inner_kind": "csr",
        "inner": {"shape": inner.shape,
                  "row_offsets": np.asarray(inner.row_offsets),
                  "col_indices": np.asarray(inner.col_indices),
                  "values": np.asarray(inner.values)}}, "cpu")
    assert isinstance(A, ReorderedPlan) and plan_kind(A) == "rcm+merge"
    x = np.random.default_rng(2).standard_normal(j.num_cols).astype(
        np.float32)
    y = spmv(A, torch.from_numpy(x)).numpy()
    gold = spmv_numpy(_port(j), x.astype(np.float64))
    assert np.abs(y - gold).max() <= 1e-5 * np.abs(gold).max()
    with pytest.raises(ValueError):
        plan_from_arrays("reordered", {"shape": (1, 1), "nnz": 0,
                                       "order": "rcm", "perm": [0],
                                       "inv_perm": [0],
                                       "inner_kind": "reordered",
                                       "inner": {}}, "cpu")


def test_port_generator_fem2d_equals_jax():
    a = jgen.make_fem2d(1500, seed=1)
    b = gen.make_fem2d(1500, seed=1)
    for u, v in ((a.rows, b.rows), (a.cols, b.cols), (a.vals, b.vals)):
        np.testing.assert_array_equal(u, v)
