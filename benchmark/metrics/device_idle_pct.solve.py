"""device_idle_pct.solve: the share of the traced window in which no
kernel, copy or memset ran, over traced solves."""

import devtrace


def read(run):
    return devtrace.idle_pct(run.trace) if run.kind == "solve" else None
