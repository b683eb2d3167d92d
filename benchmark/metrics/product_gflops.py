"""product_gflops: useful operations (2 nnz L a call) of every product
in the window over the window's wall time, which ends at a synchronise
after the last call."""

import roofline


def read(run):
    w = run.window
    if run.kind != "product" or w.wall_s <= 0:
        return None
    flops = roofline.product_flops(run.nnz, run.lanes) * w.products
    return flops / w.wall_s / 1e9
