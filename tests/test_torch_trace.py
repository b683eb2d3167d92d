"""The port's tracer (``tpusparse_torch.utils.trace``): off by default,
spans nested by parent and request, the spans and counters of the plan,
the solvers and the products, and the spans in the profiler's timeline.

Everything runs on the CPU through the plain versions; no JAX."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse_torch import (
    CsrMatrix,
    cg_solve,
    cg_solve_multi,
    plan_kind,
    plan_matrix,
    spmm,
    spmv,
)
from tpusparse_torch.io import generators as gen
from tpusparse_torch.utils import trace


def _hpcg27(width: int) -> CsrMatrix:
    """HPCG's 27-point stencil on a width^3 grid: 26 on the diagonal, -1
    for each neighbour present."""
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(width, width))
    pattern = sp.kron(sp.kron(t, t), t)
    return CsrMatrix.from_scipy(
        (27.0 * sp.eye(width ** 3) - pattern).tocsr())


@pytest.fixture
def tracer():
    """The tracer on, with nothing in it; off and empty afterwards."""
    trace.take()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.take()


def _b(n, L=None, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n if L is None else (n, L)))


def _names(spans, **where):
    return [s.name for s in spans
            if all(getattr(s, k) == v for k, v in where.items())]


def test_off_by_default_records_nothing():
    trace.take()
    assert trace.span("a") is trace.span("b")  # one shared no-op
    plan = plan_matrix(_hpcg27(4), device="cpu")
    cg_solve(plan, _b(64), 50, 1e-8)
    trace.count("plan.nnz_scanned", 5)
    assert trace.take() == ([], {})


def test_take_returns_then_clears(tracer):
    with trace.span("outer"):
        trace.count("c", 2)
        with trace.span("inner"):
            trace.count("c")
    trace.count("c", 4)
    spans, counters = trace.take()
    assert [s.name for s in spans] == ["inner", "outer"]
    outer = spans[1].id
    assert counters == {"c": {outer: 3, None: 4}}
    assert trace.take() == ([], {})


def test_every_span_lies_in_its_parent_and_request(tracer):
    csr = _hpcg27(5)
    plan = plan_matrix(csr, device="cpu")
    cg_solve(plan, _b(125), 50, 1e-8)
    cg_solve_multi(plan, _b(125, 3), 50, 1e-8)
    spmv(plan, _b(125))
    spmm(plan, _b(125, 2))
    spans, _ = trace.take()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["plan_matrix", "cg.solve", "cg.solve",
                                       "spmv", "spmm"]
    for s in spans:
        assert s.start_ns <= s.end_ns and not s.profiled
        if s.parent is None:
            assert s.root == s.id
            continue
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, s
        assert s.root == up.root


def _solve(kind, tol, max_iters):
    if kind == "cg_solve":
        return cg_solve(plan_matrix(_hpcg27(5), device="cpu"), _b(125),
                        max_iters, tol)
    if kind == "multi_dia":   # a pure DIA plan: (L, n) state, no spmm
        return cg_solve_multi(plan_matrix(_hpcg27(5), device="cpu"),
                              _b(125, 4), max_iters, tol)
    csr = gen.make_rmat_spd(8).to_csr()   # merge plan: spmm each iteration
    plan = plan_matrix(csr, device="cpu")
    assert plan_kind(plan) == "merge"
    return cg_solve_multi(plan, _b(csr.num_rows, 3), max_iters, tol)


@pytest.mark.parametrize("kind", ["cg_solve", "multi_dia", "multi_merge"])
@pytest.mark.parametrize("max_iters", [120, 3])
def test_one_iteration_span_per_iteration(tracer, kind, max_iters):
    res = _solve(kind, 1e-8, max_iters)
    spans, counters = trace.take()
    converged = bool(torch.as_tensor(res.converged).all())
    assert converged == (max_iters > 3)
    assert _names(spans, name="cg.solve", parent=None) == ["cg.solve"]
    # cg_solve issues the next body before it reads the test that ends
    # the loop: that body opens its span, then is discarded
    discarded = sum(counters.get("cg.discarded", {}).values())
    assert discarded == (1 if kind == "cg_solve" and converged else 0)
    bodies = res.iterations + discarded
    iters = _names(spans, name="cg.iteration")
    tests = _names(spans, name="cg.test")
    assert len(iters) == bodies and res.iterations > 0
    assert len(tests) == res.iterations + (1 if converged else 0)
    # one product call a body, and none nested below it: a hybrid plan
    # (cg_solve's is one) runs its parts without a span of their own
    by_id = {s.id: s for s in spans}
    products = [s for s in spans if s.name in ("spmv", "spmm")]
    calls = [p for p in products if by_id[p.parent].name == "cg.iteration"]
    assert len(calls) == (0 if kind == "multi_dia" else bodies)
    nested = [p for p in products if p not in calls]
    assert nested == []


@pytest.mark.parametrize("matrix,passes", [
    (lambda: _hpcg27(6), 3),                       # AUTO: masked band
    (lambda: gen.make_rmat(12).to_csr(), 1),       # AUTO: merge fallback
])
def test_plan_counts_its_passes_over_the_nonzeros(tracer, matrix, passes):
    csr = matrix()
    plan = plan_matrix(csr, dtype=np.float32, device="cpu")
    assert plan_kind(plan) == ("dia" if passes == 3 else "merge")
    spans, counters = trace.take()
    root = _names(spans, parent=None)
    assert root == ["plan_matrix"]
    assert counters == {"plan.nnz_scanned": {spans[-1].id: passes * csr.nnz}}


def test_plan_children_in_order(tracer):
    plan_matrix(_hpcg27(5), device="cpu")
    spans, _ = trace.take()
    root = spans[-1]
    assert root.name == "plan_matrix" and root.parent is None
    children = sorted((s for s in spans if s.parent == root.id),
                      key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["plan.select", "plan.partition",
                                          "plan.operand"]
    operand = children[-1].id
    assert _names(spans, parent=operand) == ["plan.upload"]


def test_merge_and_reordered_plans(tracer):
    csr = gen.make_rmat_spd(8).to_csr()
    plan_matrix(csr, device="cpu")
    spans, _ = trace.take()
    top = spans[-1].id
    assert _names(spans, parent=top) == ["plan.select", "plan.operand"]
    plan_matrix(gen.make_laplacian_grid2d(12).to_csr(), device="cpu",
                reorder="rcm")
    spans, _ = trace.take()
    top = spans[-1]
    assert top.name == "plan_matrix" and top.parent is None
    assert _names(spans, parent=top.id) == ["plan.reorder", "plan.reorder",
                                            "plan_matrix", "plan.reorder"]
    assert all(s.root == top.id for s in spans)


def test_nested_products_are_children_of_the_call(tracer):
    plan = plan_matrix(_hpcg27(4), device="cpu")   # a hybrid of one part
    trace.take()
    spmv(plan, _b(64))
    spmm(plan, _b(64))            # 1-D X: spmm of one column
    spmm(plan, _b(64, 3))
    spans, _ = trace.take()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["spmv", "spmm", "spmm"]
    # only the public call opens a product span: the hybrid's diagonal
    # part and a 1-D X's 2-D product open none, and below a 2-D X's call
    # is the copy of X.T for K1d; the plain versions on the CPU open no
    # kernel.* span
    for root, chain in zip(roots, (["spmv"], ["spmm"],
                                   ["spmm", "dia.layout"])):
        below, up = [], root.id
        while True:
            kids = [s for s in spans if s.parent == up]
            assert len(kids) <= 1
            if not kids:
                break
            below.append(kids[0].name)
            up = kids[0].id
        assert [root.name] + below == chain
        assert all(s.root == root.id for s in spans
                   if s.start_ns >= root.start_ns
                   and s.end_ns <= root.end_ns)


PLANS = {
    # masked band: a float32 X (n, 16) takes K7 on the band as it is
    # (counted by spmm.nmajor), with no copy
    "masked": (lambda: gen.make_laplacian_grid3d(5).to_csr(), "auto", False),
    # value planes (K5): X (n, L) goes to (L, n) for the kernel
    "planes": (lambda: gen.make_variable_stencil(5).to_csr(), "auto", True),
    # n-major band (K7) reads (n, L) blocks as they come
    "nmajor": (lambda: gen.make_laplacian_grid3d(5).to_csr(), "nmajor",
               False),
}


@pytest.mark.parametrize("form", sorted(PLANS))
def test_spmm_counts_its_layout_change_at_the_dia_boundary(tracer, form):
    matrix, strategy, copies = PLANS[form]
    plan = plan_matrix(matrix(), strategy, dtype=np.float32, L=16,
                       device="cpu")
    n = plan.dia.num_rows
    trace.take()
    Y = spmm(plan, _b(n, 16).float())
    spans, counters = trace.take()
    assert Y.shape == (n, 16)
    root = next(s for s in spans if s.parent is None)
    assert [s.name for s in spans if s.parent is None] == ["spmm"]
    layout = [s for s in spans if s.name == "dia.layout"]
    assert [s.root for s in layout] == ([root.id] if copies else [])
    routed = {"spmm.nmajor": {root.id: 1}} if form == "masked" else {}
    if form == "planes":
        # one K5 product: K float32 planes, X (16, n) read, Y written
        K = len(plan.dia.offsets)
        routed = {"dia.planes_calls": {root.id: 1},
                  "dia.planes_bytes": {root.id: (K + 2 * 16) * n * 4}}
    assert counters == {"spmm.layout_bytes": {
        root.id: 2 * n * 16 * 4 if copies else 0}, **routed}


def test_products_that_change_no_layout_count_zero_or_nothing(tracer):
    masked = plan_matrix(gen.make_laplacian_grid3d(5).to_csr(),
                         dtype=np.float32, device="cpu")
    merge = plan_matrix(gen.make_rmat(8).to_csr(), dtype=np.float32,
                        device="cpu")
    assert plan_kind(merge) == "merge"
    XT = _b(3, 125).float()               # an (L, n) block ...
    trace.take()
    spmv(masked, _b(125).float())
    spmm(masked, _b(125).float())         # 1-D X: X.T is contiguous
    spmm(masked, XT.T)                    # ... seen as (n, L): no copy
    spmm(merge, _b(merge.num_cols, 4).float())
    spans, counters = trace.take()
    roots = [s.id for s in spans if s.parent is None]
    assert len(roots) == 4
    assert not [s for s in spans if s.name == "dia.layout"]
    assert counters == {"spmm.layout_bytes": {roots[1]: 0, roots[2]: 0}}


def test_blocked_cg_on_a_dia_plan_changes_no_layout(tracer):
    plan = plan_matrix(gen.make_laplacian_grid3d(5).to_csr(),
                       dtype=np.float32, device="cpu")
    res = cg_solve_multi(plan, _b(125, 4).float(), 100, 1e-4)
    spans, counters = trace.take()
    assert bool(res.converged.all()) and res.iterations > 0
    assert not [s for s in spans if s.name == "dia.layout"]
    assert "spmm.layout_bytes" not in counters


def test_solution_bitwise_equal_with_the_tracer_on_and_off():
    plan = plan_matrix(_hpcg27(5), device="cpu")
    b, B = _b(125), _b(125, 3, seed=1)
    off = cg_solve(plan, b, 60, 1e-8), cg_solve_multi(plan, B, 60, 1e-8)
    trace.enable()
    try:
        on = cg_solve(plan, b, 60, 1e-8), cg_solve_multi(plan, B, 60, 1e-8)
    finally:
        trace.disable()
        trace.take()
    for a, c in zip(off, on):
        assert torch.equal(a.x, c.x) and a.iterations == c.iterations


def test_spans_stand_in_the_profiler_timeline(tracer, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    plan = plan_matrix(_hpcg27(4), device="cpu")
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cg_solve(plan, _b(64), 50, 1e-8)
        spmv(plan, _b(64))
    spans, _ = trace.take()
    assert spans and all(s.profiled for s in spans)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    names = {s.name for s in spans}
    assert names == {"cg.solve", "cg.test", "cg.iteration", "spmv"}
    by_name = {n: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["tid"]) for e in events if e["name"] == n)
               for n in names}
    for n in names:
        assert len(by_name[n]) == sum(s.name == n for s in spans), n
    # the k-th span of a name is the k-th event of that name: each lies in
    # an event of its parent's name, on the same thread
    by_id = {s.id: s for s in spans}
    ordinal = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        ordinal[s.id] = sum(1 for t in spans
                            if t.name == s.name and t.start_ns < s.start_ns)
    for s in spans:
        if s.parent is None:
            continue
        up = by_id[s.parent]
        lo, hi, tid = by_name[s.name][ordinal[s.id]]
        plo, phi, ptid = by_name[up.name][ordinal[up.id]]
        assert plo <= lo and hi <= phi and tid == ptid, (s, up)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_spans_on_the_card(tracer, cuda):
    """A CG iteration on the hybrid plan opens 4 spans: the test, the
    body, the product and the hybrid's diagonal part, whose K1d launch
    opens none, and ``cg_solve``'s discarded body 3 more; on the (L, n)
    path 2. A merge plan's product call opens 2: its one child is its
    kernel's launch."""
    plan = plan_matrix(_hpcg27(6), device=cuda)            # K1d
    rmat = plan_matrix(gen.make_rmat(12).to_csr(), dtype=np.float32,
                       device=cuda)                         # K2, K3
    trace.take()
    res = cg_solve(plan, _b(216).to(cuda), 100, 1e-8)
    multi = cg_solve_multi(plan, _b(216, 4).to(cuda), 100, 1e-8)
    x = _b(rmat.num_cols).float().to(cuda)
    spmv(rmat, x)
    spmm(rmat, torch.stack([x, x], 1))
    spans, counters = trace.take()
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s.name)
    solves = [s for s in spans if s.name == "cg.solve"]
    for solve, r, product in zip(solves, (res, multi), ("spmv", None)):
        # cg_solve's body issued ahead of the test that ends the loop
        # opens its span, then is discarded
        discarded = counters.get("cg.discarded", {}).get(solve.id, 0)
        assert discarded == (1 if product else 0)
        per_iter = [s for s in spans if s.root == solve.id
                    and s.name == "cg.iteration"]
        assert len(per_iter) == r.iterations + discarded
        assert r.iterations > 0
        for it in per_iter:
            if product is None:       # (L, n) state: K1d called directly
                assert it.id not in children
            else:
                assert children[it.id] == ["spmv"]
                call = next(s for s in spans if s.parent == it.id)
                part = next(s for s in spans if s.parent == call.id)
                assert children[call.id] == ["spmv"]
                assert part.id not in children
        # the solve, one more test than iterations, and each body with
        # its product and the hybrid's part below it, or nothing
        depth = 1 if product is None else 3
        assert sum(s.root == solve.id for s in spans) == (
            1 + (r.iterations + discarded) * depth + r.iterations + 1)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots][-2:] == ["spmv", "spmm"]
    assert children[roots[-2].id] == ["kernel.K2"]
    assert children[roots[-1].id] == ["kernel.K3"]
    assert all(children.get(s.id) is None for s in spans
               if s.name.startswith("kernel."))
