"""solve_p95_ms: 95th percentile of the per-solve wall times of every
solve in the window."""

import statistics


def read(run):
    t = run.window.op_s
    if run.kind != "solve" or len(t) < 2:
        return None
    return statistics.quantiles(t, n=100, method="inclusive")[94] * 1e3
