"""Conjugate gradient, single and blocked multi-RHS (port of
``tpusparse/solvers/cg.py``).

``cg_solve``: textbook CG from x0 (0 by default; r = b - A x0 otherwise)
with the JAX package's semantics (``_cg_solve_impl``):

  * the convergence test ``sqrt(r.r) >= ||b|| * tolerance`` comes
    before each iteration's body, so a zero or already-small b takes
    no iteration;
  * ``||b|| == 0`` is replaced by 1;
  * ``alpha = 0`` when ``p.Ap == 0`` and ``beta = 0`` when ``r.r`` was
    exactly 0, so the state never turns NaN;
  * the history holds ``sqrt(r.r) / ||b||`` per iteration, NaN past the
    last one.

A custom ``matvec`` (``cg_solve``) or ``matmat`` (``cg_solve_multi``)
replaces the plan's product, as in the JAX package.

``cg_solve_multi``: blocked CG on B (n, L) from X0 = 0, each lane its
own CG, with ``_cg_solve_multi_impl``'s semantics:

  * ``converged`` is updated after each iteration's body and the loop
    runs while some lane has not converged, so a zero B takes one
    iteration (single-RHS CG takes none);
  * per-lane ``alpha = 0`` where the lane has converged or ``p.Ap ==
    0``, ``beta = 0`` where it has converged or ``r.r`` was 0: a
    converged lane freezes;
  * the history holds the largest ``sqrt(r.r) / ||b||`` over the lanes.

The dispatch layer gives the blocked loop its product and the layout of
its state (``ops.spmv.block_product``). A plan that is all diagonal runs
(no remainder), masked (K1, K1d) or value planes of any type (K5, K5d),
keeps the whole state in (L, n), the kernels' own layout, with no
transposes per iteration (the JAX package's ``_pure_dia_of`` /
``_dia_t_callable``). A pure n-major plan (``strategy='nmajor'``) with
float32 B of at most its ``L`` columns keeps the state in (n, L), K7's
own layout, and calls K7 directly (the function of the JAX package's
``_cg_solve_multi_interleaved``; only the dots' reduction order differs,
and there are no pad lanes). Every other plan keeps (n, L) and calls
``spmm``.

On a ``ReorderedPlan`` both solvers run in the permuted space, as the
JAX package's do: b (B) is permuted once on the way in and x (X) once on
the way out, both by K6, and the solve runs on the inner plan, so a pure
DIA inner plan keeps its (L, n) state. Residuals and iterations do not
depend on the order of the unknowns. With ``x0`` or a custom operator
the solve takes the JAX package's dispatch route instead: ``spmv`` on
the reordered plan permutes around each product.

The state is in ``b``'s dtype: a float64 ``b`` on a float64 plan (the
kernels K1d-K5d) keeps x, r, p, the dots, ``alpha``, ``beta`` and the
history in float64 end to end.

The loops are eager: every iteration runs the plan's kernel and BLAS-1
on the device, and the host reads each convergence test. ``cg_solve``
reads each test one iteration late. The recurrence needs no host value,
so it issues iteration i + 1's body before it waits for iteration i's
test, which reaches the host through a pinned slot while the device
works on i + 1. When the test says stop, the solve returns iteration
i's state and drops the body issued ahead, setting its history entry
back to NaN: the answers are those of reading each test first, bit for
bit, for one body more a solve. The initial residual's test is read
before any body. ``_cg_multi_loop`` reads each test before the next
body.

A solve is one ``cg.solve`` span of ``utils/trace.py``; in it each body
issued is a ``cg.iteration`` span (the product, BLAS-1 and, in
``cg_solve``, its test queued) and each test read a ``cg.test`` span
(the wait and the read). ``cg_solve`` counts ``cg.ahead``, a body issued
before the test that admits it was read, and ``cg.discarded``, such a
body dropped: a solve its test ends has iterations + 1 bodies and
tests, ``cg.ahead`` = iterations and ``cg.discarded`` = 1.

The JAX package's plan baking and its XLA matvec swap are an XLA-TPU
workaround and have no counterpart. CUDA graphs over blocks of
iterations are later work (ROADMAP A7b).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpusparse_torch.ops.blas import (
    axpy_multiple,
    axpy_multiple_t,
    axpy_single,
    dot_multiple,
    dot_multiple_t,
    dot_single,
    update_p_multiple,
    update_p_multiple_t,
    update_p_single,
)
from tpusparse_torch.ops.reorder import ReorderedPlan
from tpusparse_torch.ops.spmv import (
    SpmvStrategy,
    block_product,
    device_operand,
    dia_t_product,
    spmv,
)
from tpusparse_torch.utils import trace


@dataclasses.dataclass
class CgResult:
    """Result of ``cg_solve`` and, with per-lane fields, of
    ``cg_solve_multi``."""

    x: torch.Tensor          # solution (n,); (n, L) for cg_solve_multi
    iterations: int          # iterations executed
    converged: bool | torch.Tensor   # bool; (L,) bool tensor (multi)
    residual: float | torch.Tensor   # sqrt(r.r) / ||b||; (L,) (multi)
    history: torch.Tensor    # (max_iters,) or (0,); NaN past the end


def cg_solve(A, b: torch.Tensor, max_iters: int = 10000,
             tolerance: float = 1e-5, strategy="auto",
             x0: torch.Tensor | None = None,
             matvec: Callable | None = None, record_history: bool = False,
             bake: bool | None = None) -> CgResult:
    """Solve A x = b for a plan ``A`` of ``plan_matrix``; ``b`` lies on
    the plan's device, in the working dtype. ``x0`` is a warm start (r =
    b - A x0); ``matvec(v) -> A v`` replaces the plan's product. The
    arguments are the JAX package's, in its order: ``strategy`` is
    validated only (on a plan the JAX product does not depend on it),
    and ``bake`` is ignored (plan baking is an XLA-TPU device). A host
    ``CsrMatrix`` runs the reference product on ``b``'s device, in
    ``b``'s type."""
    with trace.span("cg.solve"):
        SpmvStrategy.parse(strategy)
        A = device_operand(A, b)
        if isinstance(A, ReorderedPlan) and x0 is None and matvec is None:
            res = cg_solve(A.inner, A.apply_perm(b), max_iters, tolerance,
                           record_history=record_history)
            return dataclasses.replace(res, x=A.apply_inv(res.x))
        mv = matvec if matvec is not None else (lambda v: spmv(A, v))
        x = torch.zeros_like(b) if x0 is None else x0
        r = b if x0 is None else b - mv(x)
        rs = dot_single(r, r)
        b_norm = torch.sqrt(dot_single(b, b))
        b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
        threshold = b_norm * tolerance
        zero = torch.zeros_like(rs)
        hist = torch.full((max_iters if record_history else 0,), float("nan"),
                          dtype=b.dtype, device=b.device)
        tests = _Tests(b.device)

        def body(state, i):
            """Issue iteration i on ``state`` = (x, r, p, r.r) and queue its
            test; return the next state and the queued test."""
            with trace.span("cg.iteration"):
                x, r, p, rs = state
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
                test = tests.queue(torch.sqrt(rs_new) >= threshold)
            return (x, r, p, rs_new), test

        state = (x, r, r, rs)                  # p = r
        ahead = None          # (state after the body last issued, its test)
        if max_iters > 0 and tests.read(
                tests.queue(torch.sqrt(rs) >= threshold)):
            ahead = body(state, 0)
        i = 0
        while ahead is not None:
            state, test = ahead
            i += 1
            if i == max_iters:
                break
            ahead = body(state, i)
            trace.count("cg.ahead")
            if not tests.read(test):
                trace.count("cg.discarded")
                if record_history:
                    hist[i] = float("nan")
                break
        x, _, _, rs = state
        rel = torch.sqrt(rs) / b_norm
        return CgResult(x=x, iterations=i, converged=bool(rel < tolerance),
                        residual=float(rel), history=hist)


class _Tests:
    """Convergence tests that reach the host without a blocking copy. On
    a CUDA device ``queue`` copies a test's flag into one of two pinned
    host slots, in turn, and records an event behind it; ``read`` waits
    for that event. Two, since a body queues its test before the last
    body's is read. On the CPU the flag is on the host already."""

    def __init__(self, device: torch.device):
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            buf = torch.empty(2, dtype=torch.bool, pin_memory=True)
            self.slots = (buf[0], buf[1])
            self.events = (torch.cuda.Event(), torch.cuda.Event())
            self.next = 0

    def queue(self, flag: torch.Tensor):
        """Start ``flag`` (a 0-d bool tensor) on its way to the host;
        return what ``read`` takes."""
        if self.stream is None:
            return flag
        k, self.next = self.next, 1 - self.next
        self.slots[k].copy_(flag, non_blocking=True)
        self.events[k].record(self.stream)
        return k

    def read(self, test) -> bool:
        """Wait for a queued test and read it: one ``cg.test`` span."""
        with trace.span("cg.test"):
            if self.stream is None:
                return bool(test)
            self.events[test].synchronize()
            return bool(self.slots[test])


def cg_solve_multi(A, B: torch.Tensor, max_iters: int = 10000,
                   tolerance: float = 1e-5, strategy="auto",
                   matmat: Callable | None = None,
                   record_history: bool = True,
                   bake: bool | None = None) -> CgResult:
    """Solve A X = B for B (n, L) lane by lane, for a plan ``A`` of
    ``plan_matrix``; ``B`` lies on the plan's device, in the working
    dtype. ``matmat(V) -> A V`` on (n, L) blocks replaces the plan's
    product. ``strategy``, ``bake`` and a host ``CsrMatrix`` as in
    ``cg_solve``."""
    if B.dim() != 2:
        raise ValueError(f"B must be (n, L), got {tuple(B.shape)}")
    with trace.span("cg.solve"):
        SpmvStrategy.parse(strategy)
        A = device_operand(A, B)
        if matmat is None and isinstance(A, ReorderedPlan):
            res = cg_solve_multi(A.inner, A.apply_perm(B), max_iters,
                                 tolerance, record_history=record_history)
            return dataclasses.replace(res, x=A.apply_inv(res.x))
        lane_dim = 1
        if matmat is None:
            matmat, lane_dim = _block_product(A, B)
        X, i, converged, rel, hist = _cg_multi_loop(
            matmat, B, lane_dim, max_iters, tolerance, record_history)
        return CgResult(x=X, iterations=i, converged=converged, residual=rel,
                        history=hist)


# The (L, n) product of a plan that is all diagonal runs, or None
# (``ops.spmv.dia_t_product``), looked up by the blocked solvers under
# this name: benchmark/tests/test_bench_control.py replaces it to fault
# a solve's state.
_dia_t_callable = dia_t_product


def _block_product(A, B):
    """``ops.spmv.block_product``'s product and state layout, its (L, n)
    product taken through ``_dia_t_callable``."""
    mm_t = _dia_t_callable(A)
    return (mm_t, 0) if mm_t is not None else block_product(A, B)


def _cg_multi_loop(matmat, B, lane_dim, max_iters, tolerance,
                   record_history, precond=None):
    """The blocked (P)CG loop on B (n, L), its state laid out with the
    lanes on ``lane_dim``: 1 for the (n, L) layout, 0 for (L, n) (B
    transposed once on the way in and X once on the way out), each with
    its BLAS-1 of ``ops/blas.py``. ``matmat`` and ``precond(R) -> Z`` (in
    R's layout, cast back to B's type) take the state's layout;
    ``precond`` makes it PCG with ``rho = r.z``; without one, Z = R and
    the loop is CG. Returns (X (n, L), iterations, converged, residuals,
    history)."""
    if lane_dim == 1:
        dot, axpy, update = dot_multiple, axpy_multiple, update_p_multiple
    else:
        dot, axpy = dot_multiple_t, axpy_multiple_t
        update = update_p_multiple_t
        B = B.T.contiguous()

    def prec(R):
        return R if precond is None else precond(R).to(B.dtype)

    L = B.shape[lane_dim]
    X = torch.zeros_like(B)
    R = B
    Z = prec(R)
    P = Z
    b_norms = torch.sqrt(dot(B, B))
    b_norms = torch.where(b_norms == 0, torch.ones_like(b_norms), b_norms)
    rs = dot(R, R)
    rho_old = rs if precond is None else dot(R, Z)
    zero = torch.zeros_like(rs)
    converged = torch.zeros(L, dtype=torch.bool, device=B.device)
    hist = torch.full((max_iters if record_history else 0,), float("nan"),
                      dtype=B.dtype, device=B.device)
    i = 0
    while i < max_iters:
        with trace.span("cg.test"):
            if bool(converged.all()):
                break
        with trace.span("cg.iteration"):
            AP = matmat(P)
            pAp = dot(P, AP)
            alpha = torch.where(converged | (pAp == 0), zero, rho_old / pAp)
            X = axpy(X, alpha, P)
            R = axpy(R, -alpha, AP)
            rs = dot(R, R)
            rel = torch.sqrt(rs) / b_norms
            converged = converged | (rel < tolerance)
            if record_history:
                hist[i] = torch.max(rel)
            Z = prec(R)
            rho_new = rs if precond is None else dot(R, Z)
            beta = torch.where(converged | (rho_old == 0), zero,
                               rho_new / rho_old)
            P = update(Z, beta, P)
            rho_old = rho_new
        i += 1
    if lane_dim == 0:
        X = X.T.contiguous()
    return X, i, converged, torch.sqrt(rs) / b_norms, hist
