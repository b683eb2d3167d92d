"""HPCG's 27-point problem and its plain reference product.

The matrix of HPCG's ``GenerateProblem_ref.cpp``: one row per point of
an nx x ny x nz grid (x fastest), 26 on the diagonal and -1 for each of
the 26 neighbours that lies inside the grid (no periodic boundary).
Rows are built on ``device`` in a few whole-grid operations and handed
back as host arrays: int32 row offsets and column indices (sorted within
each row) and the values in the configuration's type.

``reference_matmat`` is the plain reference: the same operator as a
stencil on the grid (27 x - box sum of x over the 3 x 3 x 3 cube, zeros
outside), in plain torch, never through the CSR arrays.
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
    cols, valid = [], []
    # (dz, dy, dx) in lexicographic order gives increasing columns
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                      & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                cols.append(row + (dz * ny + dy) * nx + dx)
                valid.append(ok)
    cols = torch.stack(cols, 1)
    valid = torch.stack(valid, 1)
    del row, ix, iy, iz
    counts = valid.sum(1)
    row_offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=row_offsets[1:])
    vals = torch.full((27,), -1.0, dtype=dtype, device=device)
    vals[13] = 26.0  # the centre of the cube: the diagonal
    values = vals.expand(n, 27)[valid]
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
    squeeze = X.dim() == 1
    X2 = X.reshape(-1, 1) if squeeze else X
    L = X2.shape[1]
    V = X2.T.reshape(L, nz, ny, nx)
    if absolute:
        V = V.abs()
    S = F.pad(V, (1, 1, 1, 1, 1, 1))
    S = S[..., :-2] + S[..., 1:-1] + S[..., 2:]
    S = S[..., :-2, :] + S[..., 1:-1, :] + S[..., 2:, :]
    S = S[:, :-2] + S[:, 1:-1] + S[:, 2:]
    # 26 x - (box - x), or 26 |x| + (box - |x|)
    Y = ((25.0 * V + S) if absolute else (27.0 * V - S)).reshape(L, -1).T
    return Y[:, 0] if squeeze else Y
