"""The reference suite's ``--grid3d`` 7-point lattice with Laplacian
values, and its plain reference product.

The pattern of ``InitGrid3d`` (``sparse_matrix.h``): one row per point
of an nx x ny x nz grid (x fastest), the point itself and each of its
six axis neighbours that lies inside the grid (no periodic boundary).
The values are the configuration's ``diagonal`` on the diagonal and its
``off_diagonal`` on each neighbour (6 and -1: the SPD Laplacian). Rows
are built on ``device`` in a few whole-grid operations and handed back
as host arrays: int32 row offsets and column indices (sorted within
each row) and the values in the configuration's type.

``reference_matmat`` is the plain reference: the same operator as a
stencil on the grid (diagonal x plus off-diagonal times the sum of the
six neighbours, zeros outside), in plain torch, never through the CSR
arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid(cfg) -> tuple[int, int, int]:
    return int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])


def generate(cfg, gen: torch.Generator, device) -> dict:
    """The CSR arrays of the configuration's grid (``gen`` is unused: the
    matrix is fixed by the grid). Returns host numpy arrays."""
    nx, ny, nz = grid(cfg)
    dtype = getattr(torch, cfg["dtype"])
    n = nx * ny * nz
    row = torch.arange(n, dtype=torch.int64, device=device)
    ix, iy, iz = row % nx, (row // nx) % ny, row // (nx * ny)
    # (coordinate, its width, the step along it, the column's step), in
    # order of increasing column; the diagonal is the step 0
    steps = ((iz, nz, -1, -nx * ny), (iy, ny, -1, -nx), (ix, nx, -1, -1),
             (ix, nx, 0, 0), (ix, nx, 1, 1), (iy, ny, 1, nx),
             (iz, nz, 1, nx * ny))
    cols, valid = [], []
    for coord, width, d, step in steps:
        cols.append(row + step)
        valid.append((coord + d >= 0) & (coord + d < width))
    cols = torch.stack(cols, 1)
    valid = torch.stack(valid, 1)
    del row, ix, iy, iz
    row_offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(valid.sum(1), 0, out=row_offsets[1:])
    vals = torch.full((7,), float(cfg["off_diagonal"]), dtype=dtype,
                      device=device)
    vals[3] = float(cfg["diagonal"])
    values = vals.expand(n, 7)[valid]
    col_indices = cols[valid].to(torch.int32)
    del cols, valid
    return {
        "num_rows": n, "num_cols": n,
        "row_offsets": row_offsets.to(torch.int32).cpu().numpy(),
        "col_indices": col_indices.cpu().numpy(),
        "values": values.cpu().numpy(),
    }


def reference_matmat(cfg, problem, X: torch.Tensor,
                     absolute: bool = False) -> torch.Tensor:
    """A @ X (|A| @ |X| with ``absolute``) for X (n, L) or (n,) as the
    stencil, in X's type and on X's device."""
    nx, ny, nz = grid(cfg)
    diag, off = float(cfg["diagonal"]), float(cfg["off_diagonal"])
    squeeze = X.dim() == 1
    X2 = X.reshape(-1, 1) if squeeze else X
    L = X2.shape[1]
    V = X2.T.reshape(L, nz, ny, nx)
    if absolute:
        V = V.abs()
        diag, off = abs(diag), abs(off)
    S = F.pad(V, (1, 1, 1, 1, 1, 1))
    # the six axis neighbours of every point
    nbrs = (S[:, :-2, 1:-1, 1:-1] + S[:, 2:, 1:-1, 1:-1]
            + S[:, 1:-1, :-2, 1:-1] + S[:, 1:-1, 2:, 1:-1]
            + S[:, 1:-1, 1:-1, :-2] + S[:, 1:-1, 1:-1, 2:])
    Y = (diag * V + off * nbrs).reshape(L, -1).T
    return Y[:, 0] if squeeze else Y
