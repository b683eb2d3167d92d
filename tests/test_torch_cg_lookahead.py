"""``cg_solve`` reads each convergence test one iteration late: it issues
the next body before it waits for the test. Its answers must be those of
the eager order (the test, then the body), bit for bit, and its counters
``cg.ahead`` and ``cg.discarded`` exact.

Everything runs on the CPU through the plain versions; no JAX.
``test_torch_cuda.py`` holds the card's solve to ``eager_cg`` too."""

import numpy as np
import pytest
import torch

from tpusparse_torch import cg_solve, plan_matrix, spmv
from tpusparse_torch.ops.blas import axpy_single, dot_single, update_p_single
from tpusparse_torch.utils import trace
from test_torch_trace import _hpcg27, tracer  # noqa: F401 (a fixture)


def eager_cg(A, b, max_iters, tolerance, x0=None, matvec=None,
             record_history=False):
    """CG that reads each test before it issues the next body, with
    ``cg_solve``'s arguments and arithmetic. Returns (x, iterations,
    converged, residual, history)."""
    mv = matvec if matvec is not None else (lambda v: spmv(A, v))
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - mv(x)
    p = r
    rs = dot_single(r, r)
    b_norm = torch.sqrt(dot_single(b, b))
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    threshold = b_norm * tolerance
    zero = torch.zeros_like(rs)
    hist = torch.full((max_iters if record_history else 0,), float("nan"),
                      dtype=b.dtype, device=b.device)
    i = 0
    while i < max_iters and bool(torch.sqrt(rs) >= threshold):
        Ap = mv(p)
        pAp = dot_single(p, Ap)
        alpha = torch.where(pAp == 0, zero, rs / pAp)
        x = axpy_single(x, alpha, p)
        r = axpy_single(r, -alpha, Ap)
        rs_new = dot_single(r, r)
        if record_history:
            hist[i] = torch.sqrt(rs_new) / b_norm
        beta = torch.where(rs == 0, zero, rs_new / rs)
        p = update_p_single(r, beta, p)
        rs = rs_new
        i += 1
    rel = torch.sqrt(rs) / b_norm
    return x, i, bool(rel < tolerance), float(rel), hist


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so that NaNs compare too."""
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


def assert_same_solve(res, eager):
    """``cg_solve``'s result equals ``eager_cg``'s bit for bit."""
    x, iterations, converged, residual, hist = eager
    assert res.iterations == iterations
    assert res.converged == converged
    assert res.residual == residual
    assert torch.equal(bits(res.x), bits(x))
    assert torch.equal(bits(res.history), bits(hist))


def lookahead_counts(res, max_iters):
    """(cg.ahead, cg.discarded, cg.test spans) of a solve: a body issued
    ahead for every iteration after the first; when the test ends the
    loop, one body more, dropped, and one test more."""
    by_test = res.iterations < max_iters
    if not by_test:
        return max(res.iterations - 1, 0), 0, res.iterations
    return res.iterations, int(res.iterations > 0), res.iterations + 1


TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
# case -> how the loop ends: by its test (True) or by max_iters
CASES = {"converged": True, "capped": False, "cap_at_last": False,
         "cap_after_last": True, "b_zero": True, "no_iters": False,
         "x0": True, "matvec": True}


@pytest.mark.parametrize("record_history", [False, True])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_lookahead_equals_the_eager_loop(tracer, dtype, case,
                                         record_history):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    plan = plan_matrix(_hpcg27(6), dtype=np_dtype, device="cpu")
    rng = np.random.default_rng(7)
    b = torch.from_numpy(rng.standard_normal(216).astype(np_dtype))
    tol, max_iters, kw = TOL[dtype], 500, {}
    if case in ("cap_at_last", "cap_after_last"):
        k = eager_cg(plan, b, max_iters, tol)[1]
        max_iters = k if case == "cap_at_last" else k + 1
    elif case == "capped":
        max_iters = 4
    elif case == "b_zero":
        b = torch.zeros_like(b)
    elif case == "no_iters":
        max_iters = 0
    elif case == "x0":
        kw["x0"] = torch.from_numpy(rng.standard_normal(216).astype(np_dtype))
    elif case == "matvec":
        kw["matvec"] = lambda v: spmv(plan, v) + v
    eager = eager_cg(plan, b, max_iters, tol, record_history=record_history,
                     **kw)
    trace.take()
    res = cg_solve(plan, b, max_iters, tol, record_history=record_history,
                   **kw)
    spans, counters = trace.take()
    assert_same_solve(res, eager)
    assert (res.iterations < max_iters) == CASES[case]
    assert res.converged == (case not in ("capped", "no_iters"))
    assert (res.iterations == 0) == (case in ("b_zero", "no_iters"))
    ahead, discarded, tests = lookahead_counts(res, max_iters)
    assert sum(counters.get("cg.ahead", {}).values()) == ahead
    assert sum(counters.get("cg.discarded", {}).values()) == discarded
    assert sum(s.name == "cg.test" for s in spans) == tests
    assert sum(s.name == "cg.iteration" for s in spans) == (
        res.iterations + discarded)
