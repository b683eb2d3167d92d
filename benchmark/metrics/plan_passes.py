"""plan_passes: host passes over every nonzero in the cell's
``plan_matrix`` call: the ``plan.nnz_scanned`` counter of that request
over the matrix's nonzeros."""

import program_trace

program_trace.arm()


def read(run):
    rec = program_trace.record()
    if rec is None or not run.nnz:
        return None
    spans, counters = rec
    root = program_trace.plan_request(spans)
    if root is None:
        return None
    return counters.get("plan.nnz_scanned", {}).get(root, 0) / run.nnz
