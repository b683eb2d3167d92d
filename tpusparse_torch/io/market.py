"""Matrix Market (.mtx) reader.

Port of ``tpusparse/io/market.py`` (its Python path; the native parser
is left out): coordinate and array formats, ``symmetric`` /
``skew-symmetric`` / ``hermitian`` expansion, ``pattern`` files taking
``default_value``, 1-based indices made 0-based.
"""

from __future__ import annotations

import gzip
import io as _io

import numpy as np

from tpusparse_torch.formats.coo import CooMatrix


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_market(path, default_value: float = 1.0,
                dtype=np.float64) -> CooMatrix:
    """Parse a Matrix Market file into a CooMatrix."""
    with _open(path) as f:
        return _read_market_stream(f, default_value, dtype)


def _mirror(rows, cols, vals, skew):
    off = rows != cols
    return (np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, -vals[off] if skew else vals[off]]))


def _read_market_stream(f, default_value, dtype) -> CooMatrix:
    header = f.readline()
    if not header.startswith("%%MatrixMarket"):
        raise ValueError(f"not a MatrixMarket file (banner: {header[:60]!r})")
    banner = header.lower()
    skew = "skew" in banner
    symmetric = ("symmetric" in banner and not skew) or "hermitian" in banner
    pattern = "pattern" in banner

    line = f.readline()
    while line.startswith("%"):
        line = f.readline()
    dims = line.split()
    num_rows, num_cols = int(dims[0]), int(dims[1])

    if "array" in banner:
        data = np.loadtxt(f, dtype=np.float64, ndmin=1)
        if "complex" in banner:
            data = data.reshape(-1, 2)[:, 0]
        if symmetric or skew:
            # the lower triangle, column-major
            cols = np.concatenate([np.full(num_rows - c, c)
                                   for c in range(num_cols)])
            rows = np.concatenate([np.arange(c, num_rows)
                                   for c in range(num_cols)])
            rows, cols, vals = _mirror(rows, cols, data.astype(dtype), skew)
            return CooMatrix(num_rows, num_cols, rows.astype(np.int32),
                             cols.astype(np.int32), vals)
        n = num_rows * num_cols
        idx = np.arange(n)
        cols = (idx // num_rows).astype(np.int32)
        rows = (idx - cols.astype(np.int64) * num_rows).astype(np.int32)
        return CooMatrix(num_rows, num_cols, rows, cols,
                         data[:n].astype(dtype))

    nnz_declared = int(dims[2])
    body = f.read()
    # Bulk-parse every token as float64 (indices are exact up to 2^53).
    # The field count comes from the first data line; any unparseable
    # token or a count mismatch takes the per-line loop.
    first_fields = 0
    for ln in body.splitlines():
        if ln.split():
            first_fields = len(ln.split())
            break
    try:
        raw = np.asarray(body.split(), dtype=np.float64)
    except ValueError:
        raw = None
    if (raw is None or nnz_declared <= 0 or first_fields < 2
            or raw.size != nnz_declared * first_fields):
        return _read_market_slow(body, num_rows, num_cols, nnz_declared,
                                  symmetric, skew, pattern, default_value,
                                  dtype)
    toks = raw.reshape(nnz_declared, first_fields)
    rows = toks[:, 0].astype(np.int64) - 1
    cols = toks[:, 1].astype(np.int64) - 1
    if first_fields >= 3 and not pattern:
        vals = toks[:, 2].astype(dtype)
    else:
        vals = np.full(nnz_declared, default_value, dtype=dtype)
    if symmetric or skew:
        rows, cols, vals = _mirror(rows, cols, vals, skew)
    idt = np.int32 if max(num_rows, num_cols) < 2**31 else np.int64
    return CooMatrix(num_rows, num_cols, rows.astype(idt), cols.astype(idt),
                     vals)


def _read_market_slow(body, num_rows, num_cols, nnz_declared, symmetric,
                      skew, pattern, default_value, dtype):
    rows, cols, vals = [], [], []
    n_primitive = 0
    for line in _io.StringIO(body):
        parts = line.split()
        if len(parts) < 2:
            continue
        r, c = int(parts[0]) - 1, int(parts[1]) - 1
        v = default_value
        if len(parts) >= 3 and not pattern:
            try:
                v = float(parts[2])
            except ValueError:
                v = default_value
        rows.append(r)
        cols.append(c)
        vals.append(v)
        n_primitive += 1
        if (symmetric or skew) and r != c:
            rows.append(c)
            cols.append(r)
            vals.append(-v if skew else v)
    if n_primitive != nnz_declared:
        raise ValueError(
            f"matrix body holds {n_primitive} entries but the header "
            f"declares {nnz_declared}")
    return CooMatrix(num_rows, num_cols, np.array(rows, dtype=np.int32),
                     np.array(cols, dtype=np.int32),
                     np.array(vals, dtype=dtype))
