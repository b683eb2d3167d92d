"""The yardstick of a product: its useful operations, its least bytes,
and the least time the card could take for them.

Peaks are the published ones of one NVIDIA H100 SXM at its full 700 W
limit (NVIDIA's data sheet): HBM3 bandwidth, and float32 and float64
outside the tensor cores. The least bytes belong to the configuration,
not to the plan that runs it: its file gives them as bytes per stored
nonzero, per row offset (num_rows + 1 of them) and per row and lane
(the vectors read and written once), so a plan that moves more bytes
reads lower, and one that moves fewer does not move the bound.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}


def product_flops(nnz: int, lanes: int) -> float:
    """Useful operations of one product: a multiply and an add per
    stored nonzero and lane."""
    return 2.0 * nnz * lanes


def least_bytes(cfg, num_rows: int, nnz: int, lanes: int) -> float:
    """Least bytes of one product, from the configuration's
    ``least_bytes`` entry."""
    lb = cfg["least_bytes"]
    return (lb["per_nonzero"] * nnz + lb["per_row_offset"] * (num_rows + 1)
            + lb["per_row_lane"] * num_rows * lanes)


def least_ms(cfg, num_rows: int, nnz: int, lanes: int) -> float:
    """Least milliseconds of one product on the card: the larger of its
    operations over the peak of the configuration's type and its least
    bytes over the HBM bandwidth."""
    t_ops = product_flops(nnz, lanes) / H100_FLOPS_PER_S[cfg["dtype"]]
    t_bytes = least_bytes(cfg, num_rows, nnz, lanes) / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3


# The product kernels of tpusparse_torch/csrc, by name: every plan's
# SpMV and SpMM kernels and their fix-ups.
PRODUCT_KERNELS = (r"\b(dia_masked_kernel|dia_planes_kernel|dia_nmajor_kernel"
                   r"|merge_consume_kernel|merge_fixup_kernel"
                   r"|merge_spmm_consume_kernel|merge_spmm_fixup_kernel"
                   r"|rowsplit_spmm_kernel|rowsplit_fixup_kernel|bsr_kernel"
                   r"|csr_reference_kernel)\b")


def traced_share(run):
    """100 x the least time of one product over the product kernels'
    device time per product in the traced segment; None where the trace
    holds no product kernel."""
    if run.trace is None or run.traced is None or not run.traced.products:
        return None
    per = run.trace.kernel_seconds(PRODUCT_KERNELS) / run.traced.products
    if per <= 0:
        return None
    cfg = run.cell.cfg
    return 100.0 * least_ms(cfg, run.num_rows, run.nnz, run.lanes) / (
        per * 1e3)
