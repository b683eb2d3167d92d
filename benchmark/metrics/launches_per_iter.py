"""launches_per_iter: device kernels of the traced solves over their
iterations."""


def read(run):
    if run.kind != "solve" or run.trace is None or not run.trace.kernels:
        return None
    iters = sum(run.traced.iterations)
    return len(run.trace.kernels) / iters if iters else None
