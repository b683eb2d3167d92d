"""The one traffic generator: a closed loop over one of the program's
public entry points, driven by a traffic mix's parameters.

A mix (``benchmark/traffic/<mix>.json``) names its ``entry`` and the
number of right-hand sides ``lanes``; a solve also its ``tolerance``,
``max_iters`` and the ``pool`` of right-hand sides it draws from. The
caller is a closed loop:

* a solve is issued when the last one has returned, and each is timed
  from the call to its synchronised result; its right-hand side is
  drawn from the pool in an order fixed by the seed;
* a product is issued back to back with the same X and no sync per
  call, as a GPU program does; the window ends at a synchronise after
  the last call. The host stays at most ``IN_FLIGHT`` calls ahead of the
  device (it waits for an event of the call that many back), so the
  queue never holds more than that and the window ends close to its
  stated length.

Every input comes from the seed. A reservoir, drawn from the seed, keeps
``check_samples`` of the window's answers for the comparison.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import random
import time

import torch

# products a warm-up makes, and the bursts that time dispatch
WARMUP_CALLS = 3
IN_FLIGHT = 16
DISPATCH_BURSTS, DISPATCH_BURST_CALLS = 10, 20

# entry -> (kind, module, function) of the program's public API
ENTRIES = {
    "cg_solve": ("solve", "tpusparse_torch.solvers.cg", "cg_solve"),
    "cg_solve_multi": ("solve", "tpusparse_torch.solvers.cg",
                       "cg_solve_multi"),
    "spmv": ("product", "tpusparse_torch.ops.spmv", "spmv"),
    "spmm": ("product", "tpusparse_torch.ops.spmv", "spmm"),
}


def kind_of(mix) -> str:
    return ENTRIES[mix["entry"]][0]


def entry_of(mix):
    """The program's function, looked up at call time."""
    _, module, name = ENTRIES[mix["entry"]]
    return getattr(importlib.import_module(module), name)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Answer:
    source: int          # the pool entry a solve was given (0: a product)
    out: torch.Tensor    # x of a solve, y of a product
    reported: object = None  # a solve's reported residual


@dataclasses.dataclass
class Segment:
    """What a stretch of the loop did."""
    ops: int = 0
    wall_s: float = 0.0
    op_s: list = dataclasses.field(default_factory=list)
    iterations: list = dataclasses.field(default_factory=list)
    products: int = 0
    unconverged: int = 0
    answers: list = dataclasses.field(default_factory=list)


class Reservoir:
    """A uniform sample of ``size`` of a stream (Algorithm R)."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, make):
        if self.seen < self.size:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = make()
        self.seen += 1


class ClosedLoop:
    """The loop of one cell: ``inputs`` holds the pool of right-hand
    sides (solves) or X (products)."""

    def __init__(self, mix, plan, inputs, order_rng: random.Random,
                 device):
        self.mix, self.plan, self.inputs = mix, plan, inputs
        self.kind = kind_of(mix)
        self.fn = entry_of(mix)
        self.order, self.device = order_rng, device

    def _solve(self, j):
        m = self.mix
        return self.fn(self.plan, self.inputs[j], int(m["max_iters"]),
                       float(m["tolerance"]))

    def warm_up(self) -> None:
        """The cell's own shapes: one solve, or ``WARMUP_CALLS``
        products."""
        if self.kind == "solve":
            self._solve(0)
        else:
            for _ in range(WARMUP_CALLS):
                self.fn(self.plan, self.inputs)
        sync(self.device)

    def run(self, seconds: float | None = None, ops: int | None = None,
            reservoir: Reservoir | None = None) -> Segment:
        """Issue ops until ``seconds`` have passed (the measured window)
        or ``ops`` have been issued (a traced segment)."""
        if self.kind == "solve":
            return self._run_solves(seconds, ops, reservoir)
        return self._run_products(seconds, ops, reservoir)

    def _run_solves(self, seconds, ops, reservoir) -> Segment:
        seg = Segment()
        pool = len(self.inputs)
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            j = self.order.randrange(pool)
            ts = time.perf_counter()
            res = self._solve(j)
            sync(self.device)
            te = time.perf_counter()
            seg.op_s.append(te - ts)
            seg.iterations.append(int(res.iterations))
            seg.products += int(res.iterations)
            if not bool(torch.as_tensor(res.converged).all()):
                seg.unconverged += 1
            if reservoir is not None:
                reservoir.offer(lambda: Answer(j, res.x, res.residual))
            seg.ops += 1
            if ops is not None and seg.ops >= ops:
                break
            if seconds is not None and te - t0 >= seconds:
                break
        seg.wall_s = te - t0
        return seg

    def _run_products(self, seconds, ops, reservoir) -> Segment:
        seg = Segment()
        events = collections.deque()
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            y = self.fn(self.plan, self.inputs)
            if self.device.type == "cuda":
                events.append(torch.cuda.Event())
                events[-1].record()
                if len(events) > IN_FLIGHT:
                    events.popleft().synchronize()
            if reservoir is not None:
                reservoir.offer(lambda: Answer(0, y))
            seg.ops += 1
            if ops is not None and seg.ops >= ops:
                break
            if (seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                break
        sync(self.device)
        seg.wall_s = time.perf_counter() - t0
        seg.products = seg.ops
        return seg

    def dispatch_seconds(self) -> list:
        """Host seconds inside each product call, with no sync per call:
        ``DISPATCH_BURSTS`` bursts of ``DISPATCH_BURST_CALLS`` calls, the
        queue drained before each burst so that no call waits for it."""
        out = []
        for _ in range(DISPATCH_BURSTS):
            sync(self.device)
            for _ in range(DISPATCH_BURST_CALLS):
                t = time.perf_counter()
                self.fn(self.plan, self.inputs)
                out.append(time.perf_counter() - t)
        sync(self.device)
        return out


def make_inputs(mix, matrix, cfg, problem, gen: torch.Generator,
                dtype, device):
    """The seed's inputs: X (n, lanes), or x (n,) at one lane, for a
    product; for a solve a pool of right-hand sides B = A X*, X* drawn
    from a standard normal, made with the configuration's reference
    product."""
    n, L = problem["num_rows"], int(mix["lanes"])
    shape = (n,) if L == 1 else (n, L)
    if kind_of(mix) == "product":
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)
    pool = []
    for _ in range(int(mix["pool"])):
        xs = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        pool.append(matrix.reference_matmat(cfg, problem, xs).contiguous())
    return pool
