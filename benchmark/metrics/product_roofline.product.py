"""product_roofline.product: the least time of one product over the
product kernels' device time per call, in the traced calls."""

import roofline


def read(run):
    return roofline.traced_share(run) if run.kind == "product" else None
