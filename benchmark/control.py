"""The control of a cell: the plain reference put in the program's
place, one precision below the configuration's type
(``reference.LOWER``), on the cell's own inputs at its own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For every seed it builds the cell's matrix and inputs as a run does and
prints one JSON line with the numbers that decide ``correct``, compared
with the cell's limits: a control that passes them shows that the
comparison cannot tell the program from the control, so every seed's
line has to read ``"fails": true``. A product's control is the
reference product on X and the matrix rounded to the lower type; a
solve's is ``reference.reference_cg`` in the lower type on the first
``check_samples`` right-hand sides of the pool. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

import closed_loop  # noqa: E402
import harness  # noqa: E402
import reference  # noqa: E402


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    """The numbers of the control on seed ``seed``'s inputs, each
    {value, limit}."""
    problem = cell.matrix.generate(
        cell.cfg, harness.generator(seed, "matrix", device), device)
    inputs = closed_loop.make_inputs(
        cell.mix, cell.matrix, cell.cfg, problem,
        harness.generator(seed, "inputs", device), cell.dtype, device)
    lower = reference.LOWER[cell.dtype]

    def matmat(V):
        return cell.matrix.reference_matmat(cell.cfg, problem, V)

    if cell.kind == "product":
        answers, unconverged = [closed_loop.Answer(0, matmat(
            inputs.to(lower)))], 0
    else:
        answers, unconverged = [], 0
        for j in range(int(cell.mix["check_samples"])):
            B = inputs[j]
            X, _, done, rep = reference.reference_cg(
                matmat, (B.reshape(-1, 1) if B.dim() == 1 else B).to(lower),
                float(cell.mix["tolerance"]), int(cell.mix["max_iters"]))
            answers.append(closed_loop.Answer(j, X, rep))
            unconverged += int(not bool(done.all()))
    return harness.numbers(cell, problem, inputs, answers, unconverged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = harness.find_cell(ROOT, args.workload, False)
    for seed in args.seeds:
        t = time.perf_counter()
        nums = control_numbers(cell, seed, device)
        fails = any(c["value"] > c["limit"] for c in nums.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": str(reference.LOWER[cell.dtype]),
                          "numbers": nums, "fails": fails,
                          "seconds": time.perf_counter() - t}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
