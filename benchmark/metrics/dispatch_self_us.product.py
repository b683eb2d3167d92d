"""dispatch_self_us.product: host microseconds of the dispatch layer's
own work in a product call: an ``spmv`` or ``spmm`` call of the dispatch
bursts (the calls ``dispatch_us.product`` times, the profiler off) less
the ``kernel.*`` spans below it (the launches: allocations and the
ctypes call), the mean over the bursts' calls. The argument checks,
casts and the plan's routing are what is left."""

import program_trace

program_trace.arm()


def read(run):
    if run.kind != "product":
        return None
    rec = program_trace.record()
    if rec is None:
        return None
    spans, _ = rec
    calls = program_trace.burst_requests(spans, ("spmv", "spmm"))
    if not calls:
        return None
    own = sum(s.seconds for s in calls.values())
    own -= sum(s.seconds for s in spans
               if s.root in calls and s.name.startswith("kernel."))
    return own * 1e6 / len(calls)
