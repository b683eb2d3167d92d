"""plan_operand_s: host seconds of the ``plan.operand`` spans of the
cell's ``plan_matrix`` call: the ``to_device_*`` call that makes the
device operand (masks, planes, tile starts), its host-to-device copies
(``plan.upload``) included."""

import program_trace

program_trace.arm()


def read(run):
    return program_trace.plan_seconds("plan.operand")
