"""device_idle_pct.product: the share of the traced window in which no
kernel, copy or memset ran, over traced products."""

import devtrace


def read(run):
    return devtrace.idle_pct(run.trace) if run.kind == "product" else None
