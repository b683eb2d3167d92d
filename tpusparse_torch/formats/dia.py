"""DIA (diagonal) partition of a CSR matrix, and its value planes on a
device.

Port of ``tpusparse/formats/dia.py``. ``select_diagonals`` picks the
diagonals ``off = col - row`` dense enough to stream, ``partition_dia``
splits a CSR into those diagonals (``DiaHost``) and a CSR remainder,
and ``plane_constants`` detects constant-coefficient diagonals, which
compress to one bit per row (``kernels/dia_stream.mask_words``).
``to_device_dia`` ships the K value planes (``DiaDevice``), float32 or
bf16 for the value-plane kernel K5, float64 for its twin K5d.

Layout: ``data[k, i] = A[i, i + offsets[k]]``, zero where out of range.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix

# Occupancy a diagonal needs (against num_rows) to be selected, and the
# most diagonals selected; the same thresholds as the JAX package, so
# both packages split a matrix the same way.
MIN_OCCUPANCY = 0.25
MAX_DIAGS = 64

# Plane types of a DiaDevice: float32 and bf16 (K5), float64 (K5d).
PLANE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


@dataclasses.dataclass
class DiaHost:
    """Host-side DIA plan: ``data[k, i] = A[i, i + offsets[k]]``."""

    num_rows: int
    num_cols: int
    offsets: np.ndarray   # (K,) int64, sorted
    data: np.ndarray      # (K, num_rows), zero where out of range


def diagonal_profile(csr):
    """(offsets, counts, lengths) for every populated diagonal
    ``off = col - row``; lengths are the in-bounds run lengths."""
    ro = np.asarray(csr.row_offsets).astype(np.int64)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    n, m = csr.num_rows, csr.num_cols
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    off = ci - rows
    counts = np.bincount(off + n - 1, minlength=n + m - 1)
    offsets = np.flatnonzero(counts) - (n - 1)
    counts = counts[offsets + n - 1]
    lengths = np.minimum(n, m - offsets) - np.maximum(0, -offsets)
    return offsets, counts, lengths


def select_diagonals(csr, min_occ: float = MIN_OCCUPANCY,
                     max_diags: int = MAX_DIAGS) -> np.ndarray:
    """Offsets worth streaming: occupancy (count / num_rows) >=
    ``min_occ``, highest count first, at most ``max_diags``; sorted."""
    offsets, counts, _lengths = diagonal_profile(csr)
    occ = counts / max(csr.num_rows, 1)
    keep = occ >= min_occ
    offsets, counts = offsets[keep], counts[keep]
    if offsets.size > max_diags:
        offsets = offsets[np.argsort(counts)[::-1][:max_diags]]
    return np.sort(offsets)


def partition_dia(csr, offsets):
    """Split ``csr`` into (DiaHost over ``offsets``, remainder CSR).
    Duplicates on a diagonal accumulate; everything else keeps CSR
    order in the remainder."""
    ro = np.asarray(csr.row_offsets).astype(np.int64)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    va = np.asarray(csr.values)
    n, m = csr.num_rows, csr.num_cols
    offsets = np.sort(np.asarray(offsets, dtype=np.int64))
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    off = ci - rows

    if offsets.size:
        pos_c = np.minimum(np.searchsorted(offsets, off), offsets.size - 1)
        on_dia = offsets[pos_c] == off
    else:
        pos_c = np.zeros(off.shape, dtype=np.int64)
        on_dia = np.zeros(off.shape, dtype=bool)

    data = np.zeros((offsets.size, n), dtype=va.dtype)
    np.add.at(data, (pos_c[on_dia], rows[on_dia]), va[on_dia])

    keep = ~on_dia
    counts = np.bincount(rows[keep], minlength=n)
    new_ro = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ro[1:])
    rest = CsrMatrix(n, m, new_ro, ci[keep].astype(np.int32),
                     va[keep].copy())
    return DiaHost(n, m, offsets, data), rest


def plane_constants(data: np.ndarray):
    """``(vals, ok)``: ``ok[k]`` when plane k's values are exactly
    ``{0, vals[k]}`` — a constant coefficient wherever the diagonal is
    populated. Empty planes report ok=True, vals=0."""
    K = data.shape[0]
    vals = np.zeros(K, dtype=np.float64)
    ok = np.ones(K, dtype=bool)
    for k in range(K):
        nz = data[k][data[k] != 0]
        if nz.size:
            vals[k] = nz[0]
            ok[k] = bool((nz == nz[0]).all())
    return vals, ok


@dataclasses.dataclass
class DiaDevice:
    """Value-plane DIA operand on a device: ``data`` (K, num_rows),
    contiguous, float32, bf16 or float64, ``data[k, i] = A[i, i +
    offsets[k]]`` and zero out of range; ``offsets`` a static tuple of K
    ints.

    The counterpart of the JAX ``DiaDevice`` and of the value-plane form
    of the JAX ``DiaStreamDevice``; the TPU blocking of the latter
    ((nb, K, R, 128) planes, edge-halo slabs, a padded state width) has
    no counterpart here."""

    num_rows: int
    num_cols: int
    offsets: tuple
    data: torch.Tensor


def to_device_dia(dia_host: DiaHost, device,
                  plane_dtype=torch.float32) -> DiaDevice:
    """Ship a host DIA plan as value planes, even for a
    constant-coefficient operator (the JAX ``masked=False``). float64
    planes keep the host values unrounded; bf16 planes round on the host
    as the JAX package's ``prepare_stream`` does: to float32 first, then
    to bf16 with round-to-nearest-even."""
    if plane_dtype not in PLANE_DTYPES:
        raise TypeError(f"planes are float32, bf16 or float64, got "
                        f"{plane_dtype}")
    host_dtype = np.float64 if plane_dtype == torch.float64 else np.float32
    planes = torch.from_numpy(
        np.ascontiguousarray(dia_host.data, dtype=host_dtype))
    return DiaDevice(dia_host.num_rows, dia_host.num_cols,
                     tuple(int(o) for o in dia_host.offsets),
                     planes.to(plane_dtype).to(device).contiguous())
