"""setup_s: seconds from process start to the first timed call."""


def read(run):
    return run.setup_s
