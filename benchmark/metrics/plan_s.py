"""plan_s: host seconds of plan_matrix in set-up."""


def read(run):
    return run.setup.get("plan_matrix")
