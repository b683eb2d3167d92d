"""planes_read_ratio.solve: the bytes a value-plane product (K5, K5d)
reads and writes as the plan lays them out, over the configuration's
least bytes of one product (``roofline.least_bytes``): over the measured
window's ``cg.solve`` requests, the program's ``dia.planes_bytes`` over
its ``dia.planes_calls``. None where no request carries the counters (a
program without them, or a plan without value planes)."""

import program_trace
import roofline

program_trace.arm()


def read(run):
    if run.kind != "solve":
        return None
    rec = program_trace.record()
    if rec is None:
        return None
    spans, counters = rec
    solves = program_trace.window_requests(spans, "cg.solve", run.window.ops)
    calls = counters.get("dia.planes_calls", {})
    calls = sum(calls.get(s, 0) for s in solves)
    if not calls:
        return None
    moved = counters.get("dia.planes_bytes", {})
    per_call = sum(moved.get(s, 0) for s in solves) / calls
    return per_call / roofline.least_bytes(run.cell.cfg, run.num_rows,
                                           run.nnz, run.lanes)
