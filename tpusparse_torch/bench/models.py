"""FLOP and byte models (port of ``tpusparse/bench/models.py``).

  * SpMV GFLOP/s   = 2 * nnz * L / t
  * effective GB/s = (nnz * (2 sV + sO) + rows * L * (sO + sV)) / t
  * masked DIA     = rows * 4 B + 2L * rows * sV (mask word, x, y)
  * value-plane DIA = K * rows * plane_bytes + L * (rows + cols) * sV
                     (planes once, X read and Y written once)
  * CSR SpMM       = nnz * (sV + sO) + (rows + 1) * sO
                     + (cols + rows) * L * sV (payload and offsets once,
                     X and Y once per lane)
  * CG GFLOP/s     = (2 nnz + 10 n) * L * iters / t
  * permutation    = rows * (4 + 2 L sV) (index, X read and Y written)
  * BSR SpMM       = nb * br * bc * sV + nb * 4 + (nbr + 1) * 4
                     + (cols + rows) * L * sV (blocks, block columns and
                     block-row offsets once, X read and Y written once);
                     2 * nb * br * bc * L flops (every stored entry)
  * PCG flops      = CG's + 2 nnz(M) L per iteration for an SpMM
                     preconditioner (SPAI), + sweeps * 2 * 2 nnz(L) L
                     for Jacobi IC(0) (two triangles, a product per
                     sweep each)

sV is the size of a value (4 B in float32, 8 B in float64), sO of an
offset. The TPU's measured stream ceilings are left out: a bound on the
card is taken against the H100's published peaks (``bound_ms``), the
float64 peak for float64 work.
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
    """Masked DIA: one 4 B mask word per row, x and y (``value_bytes``
    each) streamed once."""
    return (4 + 2 * L * value_bytes) * rows


def dia_planes_bytes(rows: int, cols: int, K: int, L: int = 1,
                     plane_bytes: int = 4, value_bytes: int = 4) -> float:
    """Value-plane DIA: K planes of ``plane_bytes`` per row read once
    for all L lanes, X (L, cols) read once and Y (L, rows) written once,
    ``value_bytes`` per entry (4 with float32 and bf16 planes, 8 with
    float64 planes)."""
    return K * rows * plane_bytes + L * (rows + cols) * value_bytes


def spmm_bytes(nnz: int, rows: int, cols: int, L: int = 1,
               value_bytes: int = 4, index_bytes: int = 4) -> float:
    """Least bytes a CSR SpMM moves: column index and value of every
    nonzero once, the row offsets once, X (cols, L) read once and Y
    (rows, L) written once."""
    return (nnz * (value_bytes + index_bytes) + (rows + 1) * index_bytes
            + (cols + rows) * L * value_bytes)


def bsr_bytes(num_blocks: int, block_rows: int, block_cols: int,
              rows: int, cols: int, L: int = 1,
              value_bytes: int = 4) -> float:
    """Least bytes a BCSR SpMM moves: every stored block entry, its
    block-column index and the block-row offsets once, X (cols, L) read
    once and Y (rows, L) written once."""
    nbr = -(-rows // block_rows)
    return (num_blocks * (block_rows * block_cols * value_bytes + 4)
            + (nbr + 1) * 4 + (cols + rows) * L * value_bytes)


def bsr_flops(num_blocks: int, block_rows: int, block_cols: int,
              L: int = 1) -> float:
    """Operations of a BCSR SpMM: a multiply and an add per stored block
    entry and lane, zeros of the blocks included."""
    return 2.0 * num_blocks * block_rows * block_cols * L


def cg_flops(nnz: int, n: int, L: int, iters: int) -> float:
    return (2.0 * nnz + 10.0 * n) * L * iters


def permute_bytes(rows: int, L: int = 1, value_bytes: int = 4) -> float:
    """y = x[perm]: a 4 B index per row, X (rows, L) read and Y written
    once."""
    return rows * (4 + 2 * value_bytes * L)


def pcg_flops(nnz: int, n: int, L: int, iters: int, precond_nnz: int,
              sweeps: int | None = None) -> float:
    """PCG: CG's flops plus the preconditioner's per iteration, for an
    SpMM preconditioner of ``precond_nnz`` entries (SPAI's M) or, with
    ``sweeps``, Jacobi IC(0) on a factor of ``precond_nnz`` entries
    (sweeps x 2 triangles x 2 nnz(L) L)."""
    per = (2.0 * precond_nnz * L if sweeps is None
           else 2.0 * sweeps * 2.0 * precond_nnz * L)
    return cg_flops(nnz, n, L, iters) + per * iters


# Published peaks of one NVIDIA H100 SXM at its full 700 W limit (NVIDIA's
# data sheet): HBM3 bandwidth, and float32 and float64 outside the tensor
# cores.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12
H100_FP64_FLOPS_PER_S = 34e12


def bound_ms(flops: float, nbytes: float,
             fp64: bool = False) -> tuple[float, str]:
    """Least milliseconds the card could take for work of ``flops``
    float32 operations (float64 with ``fp64``) that moves ``nbytes``,
    and which of the two bounds it ("bytes" or "operations")."""
    peak = H100_FP64_FLOPS_PER_S if fp64 else H100_FP32_FLOPS_PER_S
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e9 if seconds > 0 else 0.0

