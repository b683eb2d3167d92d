"""FLOP and byte models (port of ``tpusparse/bench/models.py``).

  * SpMV GFLOP/s   = 2 * nnz * L / t
  * effective GB/s = (nnz * (2 sV + sO) + rows * L * (sO + sV)) / t
  * masked DIA     = (1 + 2L) * rows * 4 B (mask word, x, y)

The TPU's measured stream ceilings are left out: a roofline share on
the card is taken against the card's own published bandwidth.
"""

from __future__ import annotations


def spmv_flops(nnz: int, L: int = 1) -> float:
    return 2.0 * nnz * L


def spmv_bytes(nnz: int, rows: int, L: int = 1, value_bytes: int = 8,
               offset_bytes: int = 4) -> float:
    """Effective-bandwidth byte model: values + column indices once,
    plus a row offset and an output per row."""
    return (nnz * (2 * value_bytes + offset_bytes)
            + rows * L * (offset_bytes + value_bytes))


def dia_masked_bytes(rows: int, L: int = 1, value_bytes: int = 4) -> float:
    """Masked DIA: one 4 B mask word per row, x and y streamed once."""
    return (1 + 2 * L) * rows * value_bytes


def gflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e9 if seconds > 0 else 0.0

