"""layout_bytes.product: megabytes a product call's layout changes at
``spmm``'s DIA boundary read and write: the program's
``spmm.layout_bytes`` counter of the dispatch bursts' calls (the calls
``dispatch_us.product`` times), the mean over those calls. None where
no call carries the counter (a program without it)."""

import program_trace

program_trace.arm()


def read(run):
    if run.kind != "product":
        return None
    rec = program_trace.record()
    if rec is None:
        return None
    spans, counters = rec
    calls = program_trace.burst_requests(spans, ("spmv", "spmm"))
    counted = counters.get("spmm.layout_bytes", {})
    if not any(c in counted for c in calls):
        return None
    return sum(counted.get(c, 0) for c in calls) / len(calls) / 1e6
