"""cg_iters: CgResult.iterations, mean over the traced solves."""

import statistics


def read(run):
    if run.kind != "solve" or run.traced is None or not run.traced.iterations:
        return None
    return statistics.fmean(run.traced.iterations)
