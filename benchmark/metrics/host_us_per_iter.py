"""host_us_per_iter: host microseconds an iteration in the body of the
measured window's solves (the profiler off): the ``cg.iteration`` spans
(the product and BLAS-1 issued) over the iterations."""

import program_trace

program_trace.arm()


def read(run):
    if run.kind != "solve":
        return None
    return program_trace.per_iteration_us(run, "cg.iteration")
