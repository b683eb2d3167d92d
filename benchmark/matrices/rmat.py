"""The Graph500 Kronecker (R-MAT) graph as a CSR matrix, and its plain
reference product.

``kronecker_edges`` draws Graph500's edge list on ``device``: each edge
picks, at every one of ``scale`` levels, one quadrant of the adjacency
matrix with the initiator's probabilities (A, B, C, D = 1 - A - B - C).
``generate`` relabels the vertices by a random permutation (Graph500's
``p = randperm(N); ij = p(ij)``), mirrors every edge, keeps duplicates
and self-loops, and sorts the entries by (row, column) on the card. The
graph comes from the configuration's ``graph_seed``, so every run does
the same work; the run's generator draws every stored value from a
standard normal, in the configuration's type. The result is handed
back as host numpy arrays.

``reference_matmat`` is the plain reference: a gather, a multiply and an
``index_add_`` over blocks of nonzeros, in plain torch, from the
benchmark's own arrays (copied to the device once, at the first
reference product).
"""

from __future__ import annotations

import torch

# nonzeros a block of the reference product takes at a time
REFERENCE_BLOCK = 1 << 22


def kronecker_edges(scale: int, num_edges: int, a: float, b: float,
                    c: float, gen: torch.Generator, device):
    """(rows, cols) int64 of ``num_edges`` edges before relabelling."""
    rows = torch.zeros(num_edges, dtype=torch.int64, device=device)
    cols = torch.zeros(num_edges, dtype=torch.int64, device=device)
    for level in range(scale):
        u = torch.rand(num_edges, generator=gen, device=device)
        low_row = u < a + b                      # quadrant A or B
        high_col = ((u >= a) & low_row) | (u >= a + b + c)  # B or D
        rows |= (~low_row).to(torch.int64) << level
        cols |= high_col.to(torch.int64) << level
    return rows, cols


def generate(cfg, gen: torch.Generator, device) -> dict:
    scale = int(cfg["scale"])
    n = 1 << scale
    m = int(cfg["edgefactor"]) * n
    graph = torch.Generator(device=device)
    graph.manual_seed(int(cfg["graph_seed"]))
    rows, cols = kronecker_edges(scale, m, cfg["A"], cfg["B"], cfg["C"],
                                 graph, device)
    perm = torch.randperm(n, generator=graph, device=device)
    rows, cols = perm[rows], perm[cols]
    del perm
    key = torch.cat([rows * n + cols, cols * n + rows])  # mirrored
    del rows, cols
    key = torch.sort(key).values
    r = key // n
    col_indices = (key - r * n).to(torch.int32)
    del key
    row_offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(r, minlength=n), 0, out=row_offsets[1:])
    del r
    values = torch.randn(col_indices.shape[0], generator=gen, device=device,
                         dtype=getattr(torch, cfg["dtype"]))
    return {
        "num_rows": n, "num_cols": n,
        "row_offsets": row_offsets.to(torch.int32).cpu().numpy(),
        "col_indices": col_indices.cpu().numpy(),
        "values": values.cpu().numpy(),
    }


def _device_csr(problem, dev):
    """(row of each nonzero, column indices, values) on ``dev``, int32,
    int32 and the stored type, copied once per problem and device."""
    cache = problem.setdefault("device_csr", {})
    if dev not in cache:
        ro = torch.from_numpy(problem["row_offsets"]).to(dev)
        rows = torch.repeat_interleave(
            torch.arange(problem["num_rows"], dtype=torch.int32,
                         device=dev), (ro[1:] - ro[:-1]).long())
        cache[dev] = (rows, torch.from_numpy(problem["col_indices"]).to(dev),
                      torch.from_numpy(problem["values"]).to(dev))
    return cache[dev]


def reference_matmat(cfg, problem, X: torch.Tensor,
                     absolute: bool = False) -> torch.Tensor:
    """A @ X (|A| @ |X| with ``absolute``) for X (n, L) or (n,), in X's
    type and on X's device, over blocks of ``REFERENCE_BLOCK``
    nonzeros."""
    squeeze = X.dim() == 1
    X2 = X.reshape(-1, 1) if squeeze else X
    dev, dtype = X2.device, X2.dtype
    rows, cols, values = _device_csr(problem, dev)
    Y = torch.zeros((problem["num_rows"], X2.shape[1]), dtype=dtype,
                    device=dev)
    for s in range(0, rows.shape[0], REFERENCE_BLOCK):
        e = min(s + REFERENCE_BLOCK, rows.shape[0])
        g = X2[cols[s:e].long()]
        v = values[s:e].to(dtype)
        if absolute:
            g, v = g.abs(), v.abs()
        Y.index_add_(0, rows[s:e], g * v[:, None])
    return Y[:, 0] if squeeze else Y
