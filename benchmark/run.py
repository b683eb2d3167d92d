"""The benchmark of tpusparse_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. The
cells, configurations, metrics and bounds are listed in
``BENCHMARK.json``; their files are under ``benchmark/`` (see
``harness.py``). Earlier lines of standard output give the plan's kind
and the set-up split; the last line is the result, one JSON object. The
last lines of standard error give each number compared beside its
limit. Without a GPU, or with fewer than the cell asks for, the run
prints no result and exits with 2.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _prepare_process() -> None:
    """Before torch is imported: the program's package on the path, and
    one thread in the host's pools, so that the launching thread shares
    its cores with nothing of the run's own. (The program builds its
    kernels into ``build/`` inside the checkout by itself.)"""
    sys.path.insert(1, str(ROOT))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(out: dict, device: dict) -> dict:
    """The result's JSON object from ``harness.run_cell``'s fields and
    the device's name, count and power limit; ``checks`` comes last."""
    import harness

    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    trace = out.get("trace")
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace.device_ops],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps]}
    result["checks"] = {
        k: {"value": harness.json_number(c["value"]), "limit": c["limit"]}
        for k, c in out["checks"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_process()

    import torch

    torch.set_num_threads(1)

    import tpusparse_torch.ops.spmv  # noqa: F401
    import tpusparse_torch.solvers.cg  # noqa: F401

    phases = {"import": time.perf_counter() - CLOCK0}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2

    import harness

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", CLOCK0, phases)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "power_limit_w": _power_limit_w()}
    result = result_line(out, device)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
