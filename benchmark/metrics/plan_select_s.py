"""plan_select_s: host seconds of the plan's choice in set-up: the
``plan.select`` spans of the cell's ``plan_matrix`` call (the diagonal
profiles and the coverage gate)."""

import program_trace

program_trace.arm()


def read(run):
    return program_trace.plan_seconds("plan.select")
