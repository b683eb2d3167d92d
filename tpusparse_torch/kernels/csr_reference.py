"""KR — the reference CSR product on the card, and KRd, its float64
twin (``csrc/csr_reference.cu``).

The kernel behind ``ops/reference.csr_matvec`` and ``csr_matmat`` on a
CUDA tensor, and so behind ``strategy='reference'``. One thread per row
and lane adds the row's products in CSR order from +0.0, each product
and sum rounded apart: the order in which the CPU's ``index_add_`` adds
them, so the card's Y is the CPU's bits and repeats them call after
call. CUDA's ``index_add_`` adds with atomics in no fixed order. It
replaces no Pallas kernel: the JAX package's reference product is XLA's
segment sum (``tpusparse/ops/reference.py``).
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import trace

# KR launches since the count was last reset (CPU runs not counted).
LAUNCHES = 0
# KRd (float64) launches, counted apart.
LAUNCHES_F64 = 0


def csr_reference_kernel(num_rows: int, row_offsets: torch.Tensor,
                         col_indices: torch.Tensor, values: torch.Tensor,
                         X: torch.Tensor) -> torch.Tensor:
    """Y (num_rows, L) = A @ X for CUDA CSR tensors and X (num_cols, L),
    in the values' type (float32: KR, float64: KRd); X is cast to it.
    No rows or no lanes launch nothing. Raises for another value type or
    device; never falls back."""
    global LAUNCHES, LAUNCHES_F64
    if values.device.type != "cuda":
        raise ValueError(f"KR runs on a CUDA tensor, got {values.device}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"KR takes float32 or float64 values, got "
                        f"{values.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be (num_cols, L), got {tuple(X.shape)}")
    dev = values.device
    if X.device != dev or row_offsets.device != dev \
            or col_indices.device != dev:
        raise ValueError("KR needs the CSR tensors and X on one device")
    L = X.shape[1]
    if num_rows == 0 or L == 0:
        return torch.zeros((num_rows, L), dtype=values.dtype, device=dev)
    f64 = values.dtype == torch.float64
    with trace.span("kernel.KRd" if f64 else "kernel.KR"):
        index64 = not (row_offsets.dtype == torch.int32
                       and col_indices.dtype == torch.int32)
        itype = torch.int64 if index64 else torch.int32
        ro = row_offsets.to(itype).contiguous()
        ci = col_indices.to(itype).contiguous()
        v = values.contiguous()
        Xc = X.to(values.dtype).contiguous()
        Y = torch.empty((num_rows, L), dtype=values.dtype, device=dev)
        name = "tps_csr_reference_f64" if f64 else "tps_csr_reference"
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib, name)(ro.data_ptr(), ci.data_ptr(),
                                    v.data_ptr(), Xc.data_ptr(),
                                    Y.data_ptr(), num_rows, L,
                                    int(index64), stream)
        _build.check(rc, name)
        if f64:
            LAUNCHES_F64 += 1
        else:
            LAUNCHES += 1
        return Y
