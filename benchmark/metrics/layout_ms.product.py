"""layout_ms.product: device milliseconds a product call spends in
kernels other than the product kernels (``roofline.PRODUCT_KERNELS``):
the layout changes at ``spmm``'s boundary and any cast or scaling,
summed over the traced calls and divided by their number. None where
the trace holds no product kernel."""

import roofline


def read(run):
    if (run.kind != "product" or run.trace is None
            or not run.traced.products):
        return None
    if run.trace.kernel_seconds(roofline.PRODUCT_KERNELS) <= 0:
        return None
    other = run.trace.kernel_seconds(roofline.PRODUCT_KERNELS, invert=True)
    return other * 1e3 / run.traced.products
