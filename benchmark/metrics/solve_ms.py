"""solve_ms: the window's wall time over the solves it completed."""


def read(run):
    w = run.window
    if run.kind != "solve" or w.ops == 0:
        return None
    return w.wall_s * 1e3 / w.ops
