"""product_roofline.solve: the least time of one product over the
product kernels' device time per product, in the traced solves."""

import roofline


def read(run):
    return roofline.traced_share(run) if run.kind == "solve" else None
