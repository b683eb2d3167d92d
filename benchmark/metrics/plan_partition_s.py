"""plan_partition_s: host seconds of the ``plan.partition`` spans of the
cell's ``plan_matrix`` call: the split into diagonals and remainder and
the constant-coefficient test. None where the plan peels no diagonal."""

import program_trace

program_trace.arm()


def read(run):
    return program_trace.plan_seconds("plan.partition")
