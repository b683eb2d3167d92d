"""CEED BP3's assembled Q1 operator (``benchmark/matrices/bp3q1.py``) on
the port's value-plane path, and the float32 blocked solve on the
7-point grid (``benchmark/matrices/grid3d7.py``), at a few elements a
side on the CPU through the plain versions; no JAX.

The generator's matrix against the Q1 stencil and against its own
element-by-element reference, AUTO's plan of it (27 value planes, no
remainder), ``cg_solve`` on that plan against a dense solve, the
counters ``dia.planes_calls`` and ``dia.planes_bytes`` of K5's entry,
and ``cg_solve_multi`` in float32 on a masked band against the
benchmark's plain float64 CG."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse_torch import cg_solve, cg_solve_multi, plan_matrix, spmv
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.dia import DiaDevice
from tpusparse_torch.kernels.dia_stream import DiaStreamDevice
from tpusparse_torch.ops.hybrid import HybridPlan
from tpusparse_torch.ops.spmv import plan_kind
from test_torch_trace import _hpcg27, tracer  # noqa: F401 (a fixture)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"


def _load(rel):
    path = BENCH / rel
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bp3q1 = _load("matrices/bp3q1.py")
grid3d7 = _load("matrices/grid3d7.py")
reference = _load("reference.py")


def _cfg(elements, perturb=0.2):
    return {"dtype": "float64", "elements": elements, "order": 1,
            "quad_points": 3, "perturb": perturb, "mesh_seed": 1}


def _problem(elements, perturb=0.2):
    cfg = _cfg(elements, perturb)
    return cfg, bp3q1.generate(cfg, None, "cpu")


def _scipy(p):
    return sp.csr_matrix((p["values"], p["col_indices"], p["row_offsets"]),
                         shape=(p["num_rows"], p["num_cols"]))


def _csr(p):
    return CsrMatrix(p["num_rows"], p["num_cols"], p["row_offsets"],
                     p["col_indices"], p["values"])


@pytest.mark.parametrize("elements", [4, 5, 6])
def test_counts_and_arrays(elements):
    _, p = _problem(elements)
    m = elements - 1
    assert p["num_rows"] == p["num_cols"] == m ** 3
    assert p["col_indices"].shape[0] == (3 * m - 2) ** 3
    assert p["row_offsets"].dtype == np.int32
    assert p["col_indices"].dtype == np.int32
    assert p["values"].dtype == np.float64
    ro, ci = p["row_offsets"], p["col_indices"]
    for r in range(p["num_rows"]):
        assert np.all(np.diff(ci[ro[r]:ro[r + 1]]) > 0)


@pytest.mark.parametrize("elements", [5, 6])
def test_symmetric_positive_definite(elements):
    _, p = _problem(elements)
    A = _scipy(p)
    # the lower slots are read from the mirrored upper ones: exact
    assert abs(A - A.T).max() == 0.0
    assert np.linalg.eigvalsh(A.toarray()).min() > 0


@pytest.mark.parametrize("elements", [4, 6])
def test_unperturbed_rows_are_the_q1_stencil(elements):
    """On the affine uniform mesh every row is the 27-point Q1 stencil:
    8h/3 on the diagonal, 0 for a face neighbour, -h/6 for an edge one,
    -h/12 for a corner one. 1e-14 h: a sum of at most eight element
    entries of size ~h, each rounded once or twice from exact values."""
    _, p = _problem(elements, perturb=0.0)
    h, m = 1.0 / elements, elements - 1
    want = {0: 8 * h / 3, 1: 0.0, 2: -h / 6, 3: -h / 12}
    ro, ci, va = p["row_offsets"], p["col_indices"], p["values"]
    for r in range(p["num_rows"]):
        for k in range(ro[r], ro[r + 1]):
            d = np.array(np.unravel_index(ci[k], (m, m, m))) - np.array(
                np.unravel_index(r, (m, m, m)))
            assert abs(va[k] - want[int(np.abs(d).sum())]) <= 1e-14 * h


def test_every_jacobian_is_positive():
    """The configuration's mesh passes the check at every quadrature
    point; a node pushed past its neighbour folds an element and fails
    it."""
    cfg = _cfg(6)
    coords = bp3q1.mesh(cfg, "cpu")
    h = 1.0 / 6
    assert float((coords[1:-1, 1:-1, 1:-1] - bp3q1.mesh(
        _cfg(6, 0.0), "cpu")[1:-1, 1:-1, 1:-1]).abs().max()) <= 0.2 * h
    for _ in bp3q1.element_matrices(cfg, coords):
        pass
    folded = coords.clone()
    folded[3, 3, 3, 0] += 1.5 * h
    with pytest.raises(ValueError, match="not positive"):
        for _ in bp3q1.element_matrices(cfg, folded):
            pass


@pytest.mark.parametrize("L", [1, 3])
def test_reference_is_the_assembled_matrix(L):
    """Element by element against the CSR product, float64: the two sum
    the same element entries in different orders, so they agree to a
    few units in the last place of |A| |x|."""
    cfg, p = _problem(6)
    A = _scipy(p)
    gen = torch.Generator().manual_seed(7)
    X = torch.randn((A.shape[0], L) if L > 1 else (A.shape[0],),
                    generator=gen, dtype=torch.float64)
    got = bp3q1.reference_matmat(cfg, p, X)
    assert got.shape == X.shape and got.dtype == torch.float64
    den = abs(A) @ X.abs().numpy()
    assert np.all(np.abs(got.numpy() - A @ X.numpy()) <= 1e-14 * den)
    # |K_e| |x_e| summed over elements bounds |A| |x| from above
    bound = bp3q1.reference_matmat(cfg, p, X, absolute=True).numpy()
    assert np.all(bound >= den * (1 - 1e-14))


def test_reference_rounds_to_the_vectors_type():
    cfg, p = _problem(5)
    x = torch.randn(p["num_rows"], dtype=torch.float64)
    y32 = bp3q1.reference_matmat(cfg, p, x.to(torch.float32))
    assert y32.dtype == torch.float32
    y64 = bp3q1.reference_matmat(cfg, p, x)
    err = float((y32.double() - y64).abs().max() / y64.abs().max())
    assert 0 < err < 1e-5


@pytest.mark.parametrize("elements", [5, 6])
def test_auto_plans_value_planes_and_no_remainder(elements):
    _, p = _problem(elements)
    plan = plan_matrix(_csr(p), device="cpu")
    assert isinstance(plan, HybridPlan) and plan.rest is None
    assert isinstance(plan.dia, DiaDevice)
    assert plan.dia.data.dtype == torch.float64
    m = elements - 1
    assert sorted(plan.dia.offsets) == sorted(
        dz * m * m + dy * m + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1)
        for dx in (-1, 0, 1))
    assert plan_kind(plan) == "dia"
    x = torch.randn(p["num_rows"], dtype=torch.float64)
    np.testing.assert_allclose(spmv(plan, x).numpy(),
                               _scipy(p) @ x.numpy(), rtol=0,
                               atol=1e-14 * float(abs(_scipy(p)).max()) * 27
                               * float(x.abs().max()))


def test_cg_on_the_plan_matches_a_dense_solve():
    """CG to 1e-5 on 27 value planes: the reported residual is below the
    tolerance, the true one equals it to float64 rounding, and the error
    against the dense solution is at most kappa x tol (relative)."""
    _, p = _problem(6)
    A = _scipy(p).toarray()
    gen = torch.Generator().manual_seed(3)
    xs = torch.randn(A.shape[0], generator=gen, dtype=torch.float64)
    b = torch.from_numpy(A @ xs.numpy())
    res = cg_solve(plan_matrix(_csr(p), device="cpu"), b, 2000, 1e-5)
    assert res.converged and res.residual < 1e-5 and res.iterations > 0
    x = res.x.numpy()
    true = np.linalg.norm(b.numpy() - A @ x) / np.linalg.norm(b.numpy())
    assert abs(true - res.residual) <= 1e-12
    w = np.linalg.eigvalsh(A)
    exact = np.linalg.solve(A, b.numpy())
    err = np.linalg.norm(x - exact) / np.linalg.norm(exact)
    assert err <= w.max() / w.min() * 1e-5


def test_planes_counters_on_one_product(tracer):  # noqa: F811
    """One ``spmv`` on value planes counts one K5 product and its bytes:
    K x n planes of 8 B, x read and y written, 8 B each."""
    _, p = _problem(5)
    plan = plan_matrix(_csr(p), device="cpu")
    tracer.take()
    x = torch.randn(p["num_rows"], dtype=torch.float64)
    spmv(plan, x)
    _, counters = tracer.take()
    n, K = p["num_rows"], len(plan.dia.offsets)
    assert K == 27
    assert sum(counters["dia.planes_calls"].values()) == 1
    assert sum(counters["dia.planes_bytes"].values()) == K * n * 8 + 2 * n * 8


def test_planes_counters_count_every_product_of_a_solve(tracer):  # noqa: F811
    """Under ``cg_solve`` each product counts under the solve's request:
    one for each iteration and one for the body its test discards."""
    _, p = _problem(5)
    plan = plan_matrix(_csr(p), device="cpu")
    b = torch.randn(p["num_rows"], dtype=torch.float64)
    tracer.take()
    res = cg_solve(plan, b, 2000, 1e-5)
    spans, counters = tracer.take()
    solve = [s.id for s in spans if s.name == "cg.solve"]
    assert len(solve) == 1
    n = p["num_rows"]
    assert counters["dia.planes_calls"] == {solve[0]: res.iterations + 1}
    assert counters["dia.planes_bytes"] == {
        solve[0]: (res.iterations + 1) * (27 * n * 8 + 2 * n * 8)}


def test_masked_plan_counts_no_planes(tracer):  # noqa: F811
    plan = plan_matrix(_hpcg27(5), device="cpu")
    assert isinstance(plan.dia, DiaStreamDevice)
    tracer.take()
    spmv(plan, torch.randn(125, dtype=torch.float64))
    _, counters = tracer.take()
    assert "dia.planes_calls" not in counters
    assert "dia.planes_bytes" not in counters


@pytest.mark.parametrize("dims", [(7, 5, 4), (9, 8, 6)])
def test_grid3d_blocked_cg_float32_against_the_reference_solve(dims):
    """``grid3d-cg16``'s path: ``cg_solve_multi`` in float32 at L = 16 on
    the 7-point grid's masked band against ``reference_cg`` in float64
    on the stencil. Every lane converges; float32 leaves the true
    residual within 1 % of the tolerance (its gap over the recursive
    one is a few units of float32 rounding times kappa), and the two
    solutions differ by at most kappa x 2 tol (relative)."""
    cfg = {"dtype": "float32", "nx": dims[0], "ny": dims[1], "nz": dims[2],
           "diagonal": 6.0, "off_diagonal": -1.0}
    p = grid3d7.generate(cfg, None, "cpu")
    plan = plan_matrix(_csr(p), dtype=np.float32, L=16, device="cpu")
    assert isinstance(plan.dia, DiaStreamDevice) and plan.rest is None
    gen = torch.Generator().manual_seed(11)
    n = p["num_rows"]
    Xs = torch.randn((n, 16), generator=gen, dtype=torch.float32)
    B = grid3d7.reference_matmat(cfg, p, Xs).contiguous()
    res = cg_solve_multi(plan, B, 2000, 1e-5)
    assert res.x.dtype == torch.float32 and bool(res.converged.all())

    def matmat(V):
        return grid3d7.reference_matmat(cfg, p, V)

    B64 = B.double()
    X_ref, _, done, _ = reference.reference_cg(matmat, B64, 1e-5, 2000)
    assert bool(done.all())
    true = ((B64 - matmat(res.x.double())).norm(dim=0)
            / B64.norm(dim=0))
    assert float(true.max()) < 1.01e-5
    A = _scipy(p).toarray().astype(np.float64)
    w = np.linalg.eigvalsh(A)
    err = ((res.x.double() - X_ref).norm(dim=0) / X_ref.norm(dim=0))
    assert float(err.max()) <= w.max() / w.min() * 2e-5
