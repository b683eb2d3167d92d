"""test_us_per_iter: host microseconds an iteration in the measured
window's convergence tests (the profiler off): the ``cg.test`` spans
(the test and its host sync, one more than the iterations in a solve
that converges) over the iterations."""

import program_trace

program_trace.arm()


def read(run):
    if run.kind != "solve":
        return None
    return program_trace.per_iteration_us(run, "cg.test")
