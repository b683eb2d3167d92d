"""The comparison that decides ``correct`` fails the control and every
fault a cell can have, at a size a test run can hold.

The control is the plain reference one precision below the
configuration's type, in the program's place. Each fault breaks the
timed path underneath a whole run (the harness's look for a card
skipped) and has to turn ``correct`` false."""

import dataclasses
import time

import pytest
import torch

import control
import harness
from conftest import ROOT, cell_names

import tpusparse_torch.ops.spmv as spmv_mod
import tpusparse_torch.solvers.cg as cg_mod


@pytest.mark.parametrize("cell", cell_names())
def test_control_fails(tiny_root, cell):
    c = harness.find_cell(tiny_root, cell, False)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c, seed, torch.device("cpu"))
        assert any(n["value"] > n["limit"] for n in nums.values()), (seed,
                                                                     nums)


def _run(root, cell):
    return harness.run_cell(root, cell, 2**31 + 5, 0.2, False, "cpu",
                            time.perf_counter(), {"import": 0.0})


def _altered(t):
    t = t.clone()
    t.view(-1)[0] += 1.0
    return t


def _alter_answer(monkeypatch, cell):
    """A token or an answer altered where it is produced."""
    for mod, name in ((cg_mod, "cg_solve"), (cg_mod, "cg_solve_multi")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k:
                            dataclasses.replace(_o(*a, **k),
                                                x=_altered(_o(*a, **k).x)))
    for name in ("spmv", "spmm"):
        orig = getattr(spmv_mod, name)
        monkeypatch.setattr(spmv_mod, name,
                            lambda *a, _o=orig, **k: _altered(_o(*a, **k)))


def _state_unchanged(monkeypatch, cell):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(cg_mod, "axpy_single", lambda y, alpha, x: y)
    monkeypatch.setattr(cg_mod, "_dia_t_callable",
                        lambda A: (lambda P: torch.zeros_like(P)))


def _half_batch(monkeypatch, cell):
    """Half of the batch left out, the rest's answers reported for it."""
    solve = cg_mod.cg_solve_multi

    def half_solve(A, B, *a, **k):
        h = B.shape[1] // 2
        res = solve(A, B[:, :h].contiguous(), *a, **k)
        X = torch.zeros_like(B)
        X[:, :h] = res.x
        return dataclasses.replace(
            res, x=X, converged=torch.cat([res.converged] * 2),
            residual=torch.cat([res.residual] * 2))

    product = spmv_mod.spmm

    def half_product(A, X, *a, **k):
        Y = product(A, X, *a, **k)
        Y[:, Y.shape[1] // 2:] = 0
        return Y

    monkeypatch.setattr(cg_mod, "cg_solve_multi", half_solve)
    monkeypatch.setattr(spmv_mod, "spmm", half_product)


def _faults(cell):
    """The faults a cell can have: a solve's state, a batch of lanes."""
    c = harness.find_cell(ROOT, cell, False)
    out = [_alter_answer]
    if c.kind == "solve":
        out.append(_state_unchanged)
    if int(c.mix["lanes"]) > 1:
        out.append(_half_batch)
    return out


CASES = [(cell, f) for cell in cell_names() for f in _faults(cell)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_turns_correct_false(tiny_root, monkeypatch, cell, fault):
    assert _run(tiny_root, cell)["correct"]
    fault(monkeypatch, cell)
    out = _run(tiny_root, cell)
    assert out["correct"] is False, out["checks"]
