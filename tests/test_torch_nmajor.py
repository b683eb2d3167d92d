"""The port's n-major masked DIA SpMM (K7) against the JAX package's B12.

Both packages get the same host matrix and numpy-seeded right-hand
sides. The JAX side runs B12 (``tpusparse/kernels/dia_nmajor.py``) as its
own tests do, in Pallas interpret mode on the CPU; the port runs K7's
plain version.

  * K7's plain version against B12 (``to_device_dia_nmajor`` +
    ``spmm_dia_nmajor``): |dY|_il <= 2 K u (|A||X|)_il, K the planes,
    u = 2^-24 (both round each product and sum once, in offset order),
    and bitwise equal to K1's plain version on X.T, transposed back;
  * ``plan_matrix(csr, 'nmajor', L=L)``: the JAX package's plan kinds,
    padded lane count and ValueErrors;
  * ``cg_solve_multi`` / ``pcg_solve_multi`` on an n-major plan against
    the JAX package's interleaved solves: the same ``converged``,
    iterations within 1 and the history within 1e-3 relative;
  * the ``dia_nmajor`` carry: the JAX plan's packed words, unpacked,
    are the port's own, and the plan computes JAX's Y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.formats.dia import partition_dia as jpartition
from tpusparse.formats.dia import select_diagonals as jselect
from tpusparse.io import generators as jgen
from tpusparse.kernels import dia_nmajor as jnm
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import plan_kind as jplan_kind
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse.precond.ic0 import ic0_factorize as jic0
from tpusparse.solvers.cg import cg_solve_multi as jcg_multi
from tpusparse.solvers.pcg import make_ic0_preconditioner as jmake_ic0
from tpusparse.solvers.pcg import pcg_solve_multi as jpcg
from tpusparse_torch import (
    CsrMatrix,
    cg_solve_multi,
    make_ic0_preconditioner,
    pcg_solve_multi,
    plan_kind,
    plan_matrix,
    spmm,
    spmv,
)
from tpusparse_torch.formats.dia import partition_dia, select_diagonals
from tpusparse_torch.kernels import _build, dia_nmajor, dia_stream
from tpusparse_torch.utils.carry import plan_from_arrays

U = 2.0 ** -24

FIXTURES = {
    "lap3d-6": lambda: jgen.make_laplacian_grid3d(6, dtype=np.float32),
    "lap2d-17": lambda: jgen.make_laplacian_grid2d(17, dtype=np.float32),
}


def _port(j) -> CsrMatrix:
    return CsrMatrix(j.num_rows, j.num_cols, np.asarray(j.row_offsets),
                     np.asarray(j.col_indices), np.asarray(j.values))


def _X(n, L, seed=0):
    return np.random.default_rng(seed).standard_normal((n, L)).astype(
        np.float32)


def _abs_product(D, X):
    """(|A||X|) in float64 on the masked band of ``D``."""
    absB = dia_stream.from_mask_words(D.num_rows, D.num_cols, D.offsets,
                                      D.band.vals.abs().numpy(),
                                      D.band.mask.numpy(), "cpu")
    absB.vals = absB.vals.double()
    return dia_nmajor.spmm_nmajor_plain(absB, torch.from_numpy(X).abs()
                                        .double()).numpy()


@pytest.mark.parametrize("L", [2, 3, 8, 32])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_k7_plain_matches_b12(name, L):
    j = FIXTURES[name]().to_csr()
    jdia, _ = jpartition(j, jselect(j))
    jD = jnm.to_device_dia_nmajor(jdia, L=L)
    c = _port(j)
    host, rest = partition_dia(c, select_diagonals(c))
    assert rest.nnz == 0
    D = dia_nmajor.to_device_dia_nmajor(host, L, "cpu")
    assert D.L == jD.L
    X = _X(c.num_cols, L, seed=L)
    Yj = np.asarray(jnm.spmm_dia_nmajor(jD, jnp.asarray(X)))
    Y = dia_nmajor.nmajor_matmat(D.band, torch.from_numpy(X))
    assert Y.shape == (c.num_rows, L) and Y.dtype == torch.float32
    bound = 2 * len(D.offsets) * U * _abs_product(D, X)
    assert np.all(np.abs(Y.numpy().astype(np.float64) - Yj) <= bound)
    # K1's plain version on X.T, transposed back: the same bits
    YT = dia_stream.spmm_dia_masked_plain(D.band,
                                          torch.from_numpy(X).T.contiguous())
    assert torch.equal(Y, YT.T)


def _band_plus_noise():
    """lap2d-12 with a few scattered symmetric entries: a hybrid plan."""
    import scipy.sparse as sp
    from tpusparse.formats.csr import CsrMatrix as JCsr

    S = jgen.make_laplacian_grid2d(12).to_csr().to_scipy().tolil()
    rng = np.random.default_rng(3)
    for _ in range(6):
        a, b = rng.integers(0, S.shape[0], 2)
        if abs(a - b) > 20:
            S[a, b] = S[b, a] = 0.01
    return JCsr.from_scipy(sp.csr_matrix(S))


@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("case", ["pure", "hybrid"])
def test_nmajor_plan_spmm_and_spmv_match_jax(case, L):
    j = (FIXTURES["lap2d-17"]().to_csr() if case == "pure"
         else _band_plus_noise())
    jA = jplan(j, "nmajor", L=L, dtype=np.float32)
    A = plan_matrix(_port(j), "nmajor", L=L, device="cpu", dtype=np.float32)
    assert plan_kind(A) == jplan_kind(jA)
    assert plan_kind(A) == ("dia_nmajor" if case == "pure"
                            else "hybrid_dia_nmajor")
    assert A.dia.L == jA.dia.L
    X = _X(j.num_cols, L, seed=5)
    Yj = np.asarray(jspmm(jA, jnp.asarray(X)))
    Y = spmm(A, torch.from_numpy(X)).numpy()
    scale = np.abs(j.to_scipy()) @ np.abs(X.astype(np.float64))
    assert np.all(np.abs(Y - Yj) <= 16 * U * scale)
    # fewer columns than the plan's L, alpha and beta, and L = 1
    Xs = X[:, :3]
    Y0 = _X(j.num_rows, 3, seed=6)
    Yj = np.asarray(jspmm(jA, jnp.asarray(Xs), alpha=2.0, beta=0.5,
                          Y=jnp.asarray(Y0)))
    Y = spmm(A, torch.from_numpy(Xs), alpha=2.0, beta=0.5,
             Y=torch.from_numpy(Y0)).numpy()
    assert np.all(np.abs(Y - Yj) <= 64 * U * (2 * scale[:, :3]
                                              + np.abs(Y0)))
    x = np.ascontiguousarray(X[:, 0])
    assert np.all(np.abs(spmv(A, torch.from_numpy(x)).numpy()
                         - np.asarray(jspmv(jA, jnp.asarray(x))))
                  <= 16 * U * scale[:, 0])


def _nonsquare():
    import scipy.sparse as sp
    from tpusparse.formats.csr import CsrMatrix as JCsr

    return JCsr.from_scipy(sp.diags([1.0, 2.0, 3.0], [0, 1, 2],
                                    shape=(20, 24)).tocsr())


def _empty():
    from tpusparse.formats.csr import CsrMatrix as JCsr

    return JCsr(4, 4, np.zeros(5, np.int32), np.zeros(0, np.int32),
                np.zeros(0))


def _scattered():
    """A few entries on no dense diagonal."""
    from tpusparse.formats.csr import CsrMatrix as JCsr
    import scipy.sparse as sp

    return JCsr.from_scipy(sp.csr_matrix(
        (np.ones(3), ([0, 5, 9], [7, 1, 3])), shape=(10, 10)))


# (case, host CSR, plan_matrix arguments): JAX and the port raise
# ValueError alike
NMAJOR_ERRORS = [
    ("L=1", lambda: FIXTURES["lap2d-17"]().to_csr(), {"L": 1}),
    ("L=129", lambda: FIXTURES["lap2d-17"]().to_csr(), {"L": 129}),
    ("float64", lambda: FIXTURES["lap2d-17"]().to_csr(),
     {"L": 4, "dtype": np.float64}),
    ("variable-band", lambda: jgen.make_variable_stencil(6).to_csr(),
     {"L": 4}),
    ("non-square", _nonsquare, {"L": 4}),
    ("nnz-0", _empty, {"L": 4}),
    ("no-diagonals", _scattered, {"L": 4}),
]


@pytest.mark.parametrize("case,make,kw", NMAJOR_ERRORS,
                         ids=[c for c, _, _ in NMAJOR_ERRORS])
def test_nmajor_plan_errors_match_jax(case, make, kw):
    j = make()
    with pytest.raises(ValueError):
        jplan(j, "nmajor", **kw)
    with pytest.raises(ValueError):
        plan_matrix(_port(j), "nmajor", device="cpu",
                    **{"dtype": np.float32, **kw})


def test_more_columns_than_the_plan_raise_as_in_jax():
    j = FIXTURES["lap2d-17"]().to_csr()
    jA = jplan(j, "nmajor", L=3, dtype=np.float32)
    A = plan_matrix(_port(j), "nmajor", L=3, device="cpu", dtype=np.float32)
    X = _X(j.num_cols, 5)
    with pytest.raises(ValueError, match="L <= 4"):
        jspmm(jA, jnp.asarray(X))
    with pytest.raises(ValueError, match="L <= 4"):
        spmm(A, torch.from_numpy(X))
    with pytest.raises(ValueError, match="L <= 4"):
        cg_solve_multi(A, torch.from_numpy(X))
    with pytest.raises(TypeError, match="float32"):
        dia_nmajor.nmajor_matmat(A.dia.band,
                                 torch.from_numpy(X[:, :2]).double())
    with pytest.raises(ValueError, match="same device"):
        dia_nmajor.nmajor_matmat(A.dia.band, torch.zeros(j.num_cols, 2,
                                                         device="meta"))


@pytest.mark.parametrize("L", [4, 32])
def test_dia_nmajor_carry_gives_jax_y(L):
    j = FIXTURES["lap3d-6"]().to_csr()
    jA = jplan(j, "nmajor", L=L, dtype=np.float32)
    jD = jA.dia
    D = plan_from_arrays("dia_nmajor", {
        "mask_g": np.asarray(jD.mask_g), "S": jD.S, "L": jD.L,
        "offsets": jD.offsets, "vals": jD.vals,
        "shape": (jD.num_rows, jD.num_cols)}, "cpu")
    own = plan_matrix(_port(j), "nmajor", L=L, device="cpu",
                      dtype=np.float32).dia
    assert D.L == own.L and D.offsets == own.offsets
    assert torch.equal(D.band.mask, own.band.mask)
    assert torch.equal(D.band.vals, own.band.vals)
    X = _X(j.num_cols, L, seed=9)
    Y = dia_nmajor.nmajor_matmat(D.band, torch.from_numpy(X)).numpy()
    Yj = np.asarray(jnm.spmm_dia_nmajor(jD, jnp.asarray(X)))
    bound = 2 * len(D.offsets) * U * _abs_product(D, X)
    assert np.all(np.abs(Y - Yj) <= bound)
    bad = np.asarray(jD.mask_g).copy()
    bad[-1, 0] = 1
    with pytest.raises(ValueError, match="zero pad"):
        plan_from_arrays("dia_nmajor", {
            "mask_g": bad, "S": jD.S, "L": jD.L, "offsets": jD.offsets,
            "vals": jD.vals, "shape": (jD.num_rows, jD.num_cols)}, "cpu")


def _check_parity(res, jres, what):
    it, jit = res.iterations, int(jres.iterations)
    assert bool(res.converged.all()) == bool(np.all(jres.converged)), what
    assert bool(res.converged.all()), what
    assert abs(it - jit) <= 1, f"{what}: {it} vs JAX {jit}"
    k = min(it, jit)
    h, jh = res.history[:k].double().numpy(), np.asarray(jres.history)[:k]
    assert np.all(np.abs(h - jh) <= 1e-3 * np.abs(jh)), what


@pytest.mark.parametrize("L", [3, 16])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_cg_multi_on_nmajor_plan_matches_jax_interleaved(name, L):
    """cg_solve_multi keeps (n, L) state on K7 (the port's route for the
    JAX package's ``_cg_solve_multi_interleaved``)."""
    j = FIXTURES[name]().to_csr()
    B = _X(j.num_rows, L, seed=20 + L)
    jres = jcg_multi(jplan(j, "nmajor", L=L, dtype=np.float32),
                     jnp.asarray(B))
    A = plan_matrix(_port(j), "nmajor", L=L, device="cpu", dtype=np.float32)
    before = _build.LAUNCHES["K7"]
    res = cg_solve_multi(A, torch.from_numpy(B))
    assert _build.LAUNCHES["K7"] == before    # the plain version on the CPU
    assert res.x.shape == B.shape and res.x.dtype == torch.float32
    _check_parity(res, jres, f"cg_multi nmajor {name} L={L}")


@pytest.mark.parametrize("L", [3, 16])
def test_pcg_on_nmajor_plan_matches_jax_interleaved(L):
    """pcg_solve_multi on an n-major plan: (n, L) state on K7, the
    preconditioner on (n, L) with no transposes; held to the JAX
    package's ``_pcg_solve_multi_interleaved`` with the same Jacobi
    IC(0) (its sweeps on reference plans)."""
    j = FIXTURES["lap2d-17"]().to_csr()
    j64 = jgen.make_laplacian_grid2d(17).to_csr()
    jL = jic0(j64)
    B = _X(j.num_rows, L, seed=30 + L)
    jprec = jmake_ic0(jL, sweeps=2,
                      to_plan=lambda s: jplan(s, "reference",
                                              dtype=np.float32),
                      dtype=np.float32)
    jres = jpcg(jplan(j, "nmajor", L=L, dtype=np.float32), jnp.asarray(B),
                jprec)
    A = plan_matrix(_port(j), "nmajor", L=L, device="cpu", dtype=np.float32)
    prec = make_ic0_preconditioner(_port(jL), sweeps=2, num_rhs=L,
                                   dtype=np.float32, device="cpu")
    res = pcg_solve_multi(A, torch.from_numpy(B), prec)
    _check_parity(res, jres, f"pcg nmajor L={L}")


def test_nmajor_is_never_an_auto_choice():
    j = FIXTURES["lap3d-6"]().to_csr()
    for L in (1, 4, 32):
        assert plan_kind(plan_matrix(_port(j), "auto", L=L,
                                     device="cpu", dtype=np.float32)) == "dia"
        assert jplan_kind(jplan(j, "auto", L=L, dtype=np.float32)) \
            != "dia_nmajor"
