"""dispatch_us.product: mean host microseconds inside one spmv/spmm
call, no sync per call, the launch queue drained before each burst."""

import statistics


def read(run):
    if run.kind != "product" or not run.dispatch_s:
        return None
    return statistics.fmean(run.dispatch_s) * 1e6
