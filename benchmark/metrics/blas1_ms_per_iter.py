"""blas1_ms_per_iter: device milliseconds per iteration of the traced
solves in BLAS-1's passes over vectors: the kernels that are neither
product kernels (``roofline.PRODUCT_KERNELS``) nor copies or fills
(``NOT_BLAS1``) and run on a grid of more than one block.

Left out: a solve's transposes of B and X and its zeroed X (a copy or a
fill once a solve), the history's fill and its write every iteration,
and the per-lane scalars (alpha, beta, the residual norms, the
convergence test), which run on L values in one block and belong to
the solver loop. A trace without grid sizes gives nothing."""

import re

import roofline

NOT_BLAS1 = r"direct_copy_kernel|FillFunctor"


def read(run):
    if run.kind != "solve" or run.trace is None or not run.trace.kernels:
        return None
    iters = sum(run.traced.iterations)
    if not iters or any(k.blocks is None for k in run.trace.kernels):
        return None
    product = re.compile(roofline.PRODUCT_KERNELS)
    other = re.compile(NOT_BLAS1)
    sec = sum(k.seconds for k in run.trace.kernels
              if k.blocks > 1 and not product.search(k.name)
              and not other.search(k.name))
    return sec * 1e3 / iters
