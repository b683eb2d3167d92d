"""CEED bake-off problem BP3 at p = 1: the Poisson operator -div grad on
trilinear (Q1) hexahedra of a perturbed box mesh, assembled, and its
plain reference product.

The mesh is the unit cube cut into E x E x E hexahedra (E the
configuration's ``elements``, h = 1 / E), its (E + 1)^3 nodes x
fastest. Every node inside the cube moves by an offset drawn uniformly
from [-perturb h, perturb h] in each coordinate; the boundary nodes stay
on the cube's faces. The offsets come from ``mesh_seed`` on the host's
generator, so every run and every device builds the same mesh.

Each element's 8 x 8 stiffness is the integral of grad N_a . grad N_b
over the element, by the tensor 3-point Gauss-Legendre rule (q = p + 2)
on the trilinear map from the reference cube: with J the map's Jacobian
at a point and R its adjugate (J^-1 = R / det J), the integrand is
dN_a^T (R R^T / det J) dN_b on the reference gradients dN. Every
quadrature point's det J must be positive. The unknowns are the
(E - 1)^3 inside nodes (homogeneous Dirichlet conditions: the boundary
nodes are eliminated), so a row's columns are the inside nodes among
its 27 neighbours.

``generate`` assembles on ``device`` in whole-mesh operations over slabs
of element layers (at most ``CHUNK`` elements at a time): each element
pair (a, b) of a slab adds to one neighbour slot of node a, a shifted
slice of a per-node (E + 1)^3 x 27 array. Only the upper slots are
summed; the lower ones are read from the mirrored upper ones, so the
matrix is symmetric bit for bit. Every entry of the pattern is kept,
whatever its value. It hands back host int32 row offsets, sorted int32
columns and float64 values.

``reference_matmat`` applies the same operator element by element in
plain torch: each element's 8 nodal values times its 8 x 8 matrix,
added back into the nodes; it never reads the CSR arrays.
"""

from __future__ import annotations

import math

import torch

# elements of one slab of layers, at most
CHUNK = 1 << 18


def elements(cfg) -> int:
    return int(cfg["elements"])


def mesh(cfg, device) -> torch.Tensor:
    """Node coordinates (E + 1, E + 1, E + 1, 3) float64, indexed [z, y,
    x] and holding (x, y, z): the grid at spacing h, the inside nodes
    moved by the offsets of ``mesh_seed``."""
    E = elements(cfg)
    h = 1.0 / E
    g = torch.Generator()
    g.manual_seed(int(cfg["mesh_seed"]))
    shift = torch.rand((E + 1, E + 1, E + 1, 3), generator=g,
                       dtype=torch.float64)
    shift = (2.0 * shift - 1.0) * (float(cfg["perturb"]) * h)
    for axis in range(3):
        shift.narrow(axis, 0, 1).zero_()
        shift.narrow(axis, E, 1).zero_()
    t = torch.arange(E + 1, dtype=torch.float64) * h
    z, y, x = torch.meshgrid(t, t, t, indexing="ij")
    return (torch.stack((x, y, z), -1) + shift).to(device)


def _corners():
    """The 8 local nodes a = a0 + 2 a1 + 4 a2 as (a0, a1, a2)."""
    return [(a & 1, (a >> 1) & 1, a >> 2) for a in range(8)]


def _rule(device):
    """(dN (27, 8, 3), w (27,)): the trilinear shape functions'
    reference gradients at the 27 Gauss points of [0, 1]^3 (x fastest)
    and the points' weights."""
    r = math.sqrt(0.6) / 2
    pts, wts = (0.5 - r, 0.5, 0.5 + r), (5 / 18, 8 / 18, 5 / 18)
    dN = torch.zeros((27, 8, 3), dtype=torch.float64)
    w = torch.zeros(27, dtype=torch.float64)
    for q in range(27):
        qi = (q % 3, (q // 3) % 3, q // 9)
        xi = [pts[i] for i in qi]
        w[q] = wts[qi[0]] * wts[qi[1]] * wts[qi[2]]
        for a, bits in enumerate(_corners()):
            phi = [t if b else 1.0 - t for t, b in zip(xi, bits)]
            dphi = [1.0 if b else -1.0 for b in bits]
            for k in range(3):
                dN[q, a, k] = math.prod(dphi[i] if i == k else phi[i]
                                        for i in range(3))
    return dN.to(device), w.to(device)


def element_matrices(cfg, coords):
    """Yield (k0, k1, Ke) for the slabs of element layers k0 <= k < k1:
    Ke (k1 - k0, E, E, 8, 8) float64, each element's stiffness,
    symmetric bit for bit. Raises if a quadrature point's Jacobian
    determinant is not positive."""
    if int(cfg["order"]) != 1 or int(cfg["quad_points"]) != 3:
        raise ValueError("bp3q1 builds order 1 with 3 quadrature points")
    E = elements(cfg)
    dN, w = _rule(coords.device)
    # T[(q, i, j), (a, b)] = dN[q, a, i] dN[q, b, j]
    T = torch.einsum("qai,qbj->qijab", dN, dN).reshape(27 * 9, 64)
    slab = max(1, CHUNK // (E * E))
    for k0 in range(0, E, slab):
        k1 = min(E, k0 + slab)
        X = torch.stack([coords[k0 + a2:k1 + a2, a1:a1 + E, a0:a0 + E]
                         for a0, a1, a2 in _corners()], -2)
        X = X.reshape(-1, 8, 3)
        # j[i][k] (elements, 27 points): dx_i / dxi_k = sum_a X[., a, i]
        # dN[q, a, k]; the rows of the adjugate R are the cross products
        # of J's columns; each a contiguous array of its own
        j = [[X[..., i] @ dN[..., k].T for k in range(3)] for i in range(3)]
        del X
        R = [[j[1][u] * j[2][v] - j[2][u] * j[1][v],
              j[2][u] * j[0][v] - j[0][u] * j[2][v],
              j[0][u] * j[1][v] - j[1][u] * j[0][v]]
             for u, v in ((1, 2), (2, 0), (0, 1))]
        det = j[0][0] * R[0][0] + j[1][0] * R[0][1] + j[2][0] * R[0][2]
        del j
        if not bool((det > 0).all()):
            raise ValueError(
                f"a Jacobian determinant of elements in layers {k0}-{k1 - 1}"
                f" is not positive (least {float(det.min())})")
        scale = w / det
        del det
        M = {}
        for i in range(3):
            for k in range(i, 3):
                M[i, k] = M[k, i] = scale * (R[i][0] * R[k][0]
                                             + R[i][1] * R[k][1]
                                             + R[i][2] * R[k][2])
        del R, scale
        # M[c, (q, i, k)] = w det (J^-1 J^-T)[i, k] at point q
        M = torch.stack([M[i, k] for i in range(3) for k in range(3)], -1)
        Ke = (M.reshape(-1, 27 * 9) @ T).reshape(-1, 8, 8)
        Ke = (Ke + Ke.transpose(1, 2)) * 0.5
        yield k0, k1, Ke.reshape(k1 - k0, E, E, 8, 8)


def _slot(bits_a, bits_b) -> int:
    """The neighbour slot of node b seen from node a: (dz, dy, dx) in
    lexicographic order, 13 the node itself."""
    dx, dy, dz = (b - a for a, b in zip(bits_a, bits_b))
    return (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)


def generate(cfg, gen: torch.Generator, device) -> dict:
    """The CSR arrays of the assembled operator (``gen`` is unused: the
    mesh is fixed by ``mesh_seed``). Returns host numpy arrays."""
    E = elements(cfg)
    m = E - 1
    coords = mesh(cfg, device)
    V = torch.zeros((E + 1, E + 1, E + 1, 27), dtype=torch.float64,
                    device=device)
    corners = _corners()
    for k0, k1, Ke in element_matrices(cfg, coords):
        for a, (a0, a1, a2) in enumerate(corners):
            for b, bits in enumerate(corners):
                d = _slot((a0, a1, a2), bits)
                if d >= 13:
                    V[k0 + a2:k1 + a2, a1:a1 + E, a0:a0 + E, d] += Ke[..., a,
                                                                      b]
        del Ke
    inside = slice(1, E)
    n = m ** 3
    vals = torch.empty((m, m, m, 27), dtype=torch.float64, device=device)
    for d in range(27):
        dx, dy, dz = d % 3 - 1, (d // 3) % 3 - 1, d // 9 - 1
        if d >= 13:
            vals[..., d] = V[inside, inside, inside, d]
        else:
            # A[i, j] = A[j, i]: the upper slot 26 - d of the neighbour
            vals[..., d] = V[1 + dz:E + dz, 1 + dy:E + dy, 1 + dx:E + dx,
                             26 - d]
    del V
    vals = vals.reshape(n, 27)
    row = torch.arange(n, dtype=torch.int64, device=device)
    ix, iy, iz = row % m, (row // m) % m, row // (m * m)
    cols, valid = [], []
    for d in range(27):
        dx, dy, dz = d % 3 - 1, (d // 3) % 3 - 1, d // 9 - 1
        cols.append(row + (dz * m + dy) * m + dx)
        valid.append((ix + dx >= 0) & (ix + dx < m) & (iy + dy >= 0)
                     & (iy + dy < m) & (iz + dz >= 0) & (iz + dz < m))
    cols = torch.stack(cols, 1)
    valid = torch.stack(valid, 1)
    del row, ix, iy, iz
    row_offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(valid.sum(1), 0, out=row_offsets[1:])
    values = vals[valid]
    del vals
    col_indices = cols[valid].to(torch.int32)
    del cols, valid
    return {
        "num_rows": n, "num_cols": n,
        "row_offsets": row_offsets.to(torch.int32).cpu().numpy(),
        "col_indices": col_indices.cpu().numpy(),
        "values": values.cpu().numpy(),
        "coords": coords,
    }


def reference_matmat(cfg, problem, X: torch.Tensor,
                     absolute: bool = False) -> torch.Tensor:
    """A @ X (|A| @ |X| with ``absolute``) for X (n, L) or (n,), element
    by element, in X's type and on X's device: the element matrices are
    computed in float64 and rounded to X's type."""
    E = elements(cfg)
    m = E - 1
    squeeze = X.dim() == 1
    X2 = X.reshape(-1, 1) if squeeze else X
    L = X2.shape[1]
    U = torch.zeros((E + 1, E + 1, E + 1, L), dtype=X.dtype,
                    device=X.device)
    U[1:E, 1:E, 1:E] = (X2.abs() if absolute else X2).reshape(m, m, m, L)
    Y = torch.zeros_like(U)
    corners = _corners()
    coords = problem["coords"].to(X.device)
    for k0, k1, Ke in element_matrices(cfg, coords):
        Ke = (Ke.abs() if absolute else Ke).to(X.dtype)
        Ue = torch.stack([U[k0 + a2:k1 + a2, a1:a1 + E, a0:a0 + E]
                          for a0, a1, a2 in corners], -2)
        # Ye[..., a, l] = sum_b Ke[..., a, b] Ue[..., b, l]
        Ye = (Ke.unsqueeze(-1) * Ue.unsqueeze(-3)).sum(-2)
        del Ke, Ue
        for a, (a0, a1, a2) in enumerate(corners):
            Y[k0 + a2:k1 + a2, a1:a1 + E, a0:a0 + E] += Ye[..., a, :]
    out = Y[1:E, 1:E, 1:E].reshape(-1, L)
    return out[:, 0] if squeeze else out
