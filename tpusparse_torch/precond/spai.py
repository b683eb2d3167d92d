"""SPAI: static-pattern sparse approximate inverse (port of
``tpusparse/precond/spai.py``).

The reference's ``SparseApproximateInversion``: M has A's pattern; each
column k of M solves the least-squares problem min ||A[I, J] m - e_k||
over J (the pattern of column k) and I (the rows any column of J
touches), by QR; then M <- (M + M^T) / 2, since CG needs a symmetric
preconditioner.

The host work is the JAX package's vectorized construction: the row
sets are the columns of the boolean product S S (scipy); one pass over
the expanded entry list fills every dense problem; columns are grouped
in buckets of one padded shape (powers of two, with an identity row for
each padded unknown so the padded system stays full rank). Each bucket
is solved as one batched least squares, ``torch.linalg.qr`` and
``torch.linalg.solve_triangular`` in float64 on ``device`` (the card by
default). This is a library call in a set-up step, not a kernel of the
port. The JAX package pins that step to the CPU, where XLA's batched QR
beats the TPU's.

A bucket is (columns, Mi, Mj) float64 on the host and on the device:
lap3d-64's 262,144 columns at (32, 8) hold 537 MB each side; lap3d-128's
2.1 M columns would hold 4.3 GB.

``cap='auto'`` keeps the JAX package's guard against hub columns: when
the largest padded problem exceeds ``SPAI_GUARD_CELLS`` cells, the
pattern is cut to the ``SPAI_AUTO_CAP`` largest entries of each row and
column, with a warning (the JAX package prints it).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tpusparse_torch.formats.coo import CooMatrix
from tpusparse_torch.formats.csr import CsrMatrix

# The largest padded least-squares problem (Mi x Mj cells) solved before
# ``cap='auto'`` cuts the pattern, and the cap it applies.
SPAI_GUARD_CELLS = 1 << 22
SPAI_AUTO_CAP = 16


def _pow2_at_least(x, floor):
    """Elementwise next power of two >= max(x, floor)."""
    x = np.maximum(np.asarray(x, dtype=np.int64), floor)
    return (1 << np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


def _structure(csr: CsrMatrix):
    """(S, P, (nJ, nI, mj, mi)): A in CSC, the row sets I_k as the
    columns of the boolean S S, and the true and padded problem sizes."""
    import scipy.sparse as sp

    S = csr.to_scipy().tocsc()
    S.sort_indices()
    Sb = sp.csc_matrix((np.ones(S.nnz, dtype=np.int8), S.indices, S.indptr),
                       shape=S.shape)
    P = (Sb @ Sb).tocsc()
    P.sort_indices()
    nJ = np.diff(S.indptr).astype(np.int64)
    nI = np.diff(P.indptr).astype(np.int64)
    mj = _pow2_at_least(nJ, 2)
    # |I| real equations plus one identity row per padded unknown
    mi = _pow2_at_least(nI + (mj - nJ), 4)
    return S, P, (nJ, nI, mj, mi)


def _expanded_entries(S, P):
    """Every dense-problem entry in one pass: for each column k, unknown
    j_local (the j-th member of J_k) and entry (i, v) of A's column j,
    (k, j_local, local row of i in I_k, v); and where k sits in I_k."""
    n = S.shape[1]
    colptr = S.indptr.astype(np.int64)
    rows = S.indices.astype(np.int64)
    data = S.data
    colcnt = np.diff(colptr)

    rep_k = np.repeat(np.arange(n, dtype=np.int64), colcnt)
    j_local = np.arange(S.nnz, dtype=np.int64) - colptr[rep_k]

    cnt = colcnt[rows]
    total = int(cnt.sum())
    ends = np.cumsum(cnt)
    offs = np.arange(total, dtype=np.int64) - np.repeat(ends - cnt, cnt)
    src = np.repeat(colptr[rows], cnt) + offs
    i_g = rows[src]
    v_g = data[src]
    k_g = np.repeat(rep_k, cnt)
    jl_g = np.repeat(j_local, cnt)

    P_ptr = P.indptr.astype(np.int64)
    P_key = (np.repeat(np.arange(n, dtype=np.int64), np.diff(P_ptr))
             * (n + 1) + P.indices.astype(np.int64))
    local_g = np.searchsorted(P_key, k_g * (n + 1) + i_g) - P_ptr[k_g]

    ks = np.arange(n, dtype=np.int64)
    posk = np.searchsorted(P_key, ks * (n + 2))
    valid = posk < P_key.shape[0]
    in_I = np.zeros(n, dtype=bool)
    in_I[valid] = P_key[posk[valid]] == ks[valid] * (n + 2)
    e_local = np.zeros(n, dtype=np.int64)
    e_local[in_I] = (posk - P_ptr[:n])[in_I]
    return (k_g, jl_g, local_g, v_g), (in_I, e_local), rep_k, j_local


def _cap_pattern(csr: CsrMatrix, cap: int) -> CsrMatrix:
    """A symmetric pattern where entry (i, j) survives only if it is
    among the ``cap`` largest |values| of both row i and row j; the
    diagonal always survives."""
    import scipy.sparse as sp

    S = csr.to_scipy().tocsr()
    S.sort_indices()
    n = S.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    order = np.lexsort((-np.abs(S.data), rows))
    sorted_rows = rows[order]
    starts = np.searchsorted(sorted_rows, np.arange(n, dtype=np.int64))
    rank = np.arange(S.nnz, dtype=np.int64) - starts[sorted_rows]
    keep = np.zeros(S.nnz, dtype=bool)
    keep[order] = rank < cap
    K = sp.csr_matrix((keep, S.indices, S.indptr), shape=S.shape)
    K = K.multiply(K.T).tocsr()
    K.setdiag(True)
    K.eliminate_zeros()
    K.sort_indices()
    filt = S.multiply(K).tocsr()
    filt.sort_indices()
    return CsrMatrix.from_scipy(filt)


def spai_inverse(csr: CsrMatrix, batched: bool = True,
                 cap: int | None | str = "auto",
                 device="cuda") -> CsrMatrix:
    """The symmetrized SPAI approximate inverse M of the host matrix
    ``csr``, as a host CsrMatrix in float64. ``batched=True`` solves the
    bucketed least-squares problems on ``device``; ``batched=False`` is
    the per-column numpy ``lstsq`` oracle. ``cap`` bounds the pattern
    (``_cap_pattern``); ``'auto'`` applies ``SPAI_AUTO_CAP`` only past
    the hub guard, with a warning; ``None`` is the reference's uncapped
    pattern."""
    if cap == "auto":
        struct = _structure(csr)
        mj0, mi0 = struct[2][2], struct[2][3]
        cells = int((mi0 * mj0).max()) if mi0.size else 0
        if cells > SPAI_GUARD_CELLS:
            k = int(np.argmax(mi0 * mj0))
            warnings.warn(
                f"spai: hub column {k} pads to a ({int(mi0[k])}, "
                f"{int(mj0[k])}) least-squares problem ({cells / 1e6:.0f}M "
                f"cells > guard {SPAI_GUARD_CELLS / 1e6:.0f}M); applying the "
                f"symmetric cap {SPAI_AUTO_CAP} (cap=None for the "
                "reference's uncapped pattern)", stacklevel=2)
            csr = _cap_pattern(csr, SPAI_AUTO_CAP)
            struct = _structure(csr)
    else:
        if cap is not None:
            csr = _cap_pattern(csr, int(cap))
        struct = _structure(csr)
    S, P, (nJ, nI, mj, mi) = struct
    n = csr.num_cols
    entries, (in_I, e_local), rep_k, j_local = _expanded_entries(S, P)
    k_g, jl_g, local_g, v_g = entries

    sol_flat = np.zeros(S.nnz)
    if batched:
        _solve_buckets(n, nJ, nI, mj, mi, entries, in_I, e_local, rep_k,
                       j_local, sol_flat, device)
    else:
        for k in np.flatnonzero(nJ > 0):
            sel = k_g == k
            A_hat = np.zeros((nI[k], nJ[k]))
            A_hat[local_g[sel], jl_g[sel]] = v_g[sel]
            e = np.zeros(nI[k])
            if in_I[k]:
                e[e_local[k]] = 1.0
            sol = np.linalg.lstsq(A_hat, e, rcond=None)[0]
            psel = rep_k == k
            sol_flat[psel] = sol[j_local[psel]]
    M = CsrMatrix.from_coo(CooMatrix(n, n, S.indices.astype(np.int32),
                                     rep_k.astype(np.int32), sol_flat))
    return _symmetrize(M)


def _solve_buckets(n, nJ, nI, mj, mi, entries, in_I, e_local, rep_k,
                   j_local, sol_flat, device):
    """Group the columns by padded shape (Mi, Mj), fill each bucket with
    one scatter, solve it as a batched QR least squares on ``device`` in
    float64, and scatter the solutions into ``sol_flat`` (CSC order)."""
    k_g, jl_g, local_g, v_g = entries
    shape_key = mi * 10_000_000 + mj
    shape_key[nJ == 0] = -1
    uniq, b_of_k = np.unique(shape_key, return_inverse=True)
    order = np.argsort(b_of_k, kind="stable")
    counts = np.bincount(b_of_k, minlength=uniq.shape[0])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64) - starts[b_of_k[order]]

    for u, key in enumerate(uniq):
        if key < 0:
            continue
        Mi, Mj = int(key) // 10_000_000, int(key) % 10_000_000
        ks = order[starts[u]:starts[u] + counts[u]]
        nb = ks.shape[0]
        A_b = np.zeros((nb, Mi, Mj))
        e_b = np.zeros((nb, Mi, 1))
        sel = shape_key[k_g] == key
        A_b[rank[k_g[sel]], local_g[sel], jl_g[sel]] = v_g[sel]
        # identity rows for the padded unknowns: A[|I| + d, |J| + d] = 1
        pad = (Mj - nJ[ks]).astype(np.int64)
        tot = int(pad.sum())
        if tot:
            ends = np.cumsum(pad)
            dd = np.arange(tot, dtype=np.int64) - np.repeat(ends - pad, pad)
            bb = np.repeat(np.arange(nb, dtype=np.int64), pad)
            rr = nI[ks][bb] + dd
            cc = nJ[ks][bb] + dd
            ok = rr < Mi
            A_b[bb[ok], rr[ok], cc[ok]] = 1.0
        kin = ks[in_I[ks]]
        e_b[rank[kin], e_local[kin], 0] = 1.0
        sol = _batched_lstsq(torch.from_numpy(A_b).to(device),
                             torch.from_numpy(e_b).to(device)).cpu().numpy()
        psel = shape_key[rep_k] == key
        sol_flat[psel] = sol[rank[rep_k[psel]], j_local[psel]]


def _batched_lstsq(A: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """min ||A m - e|| per batch entry by reduced QR: (nb, Mi, Mj) and
    (nb, Mi, 1) -> (nb, Mj)."""
    q, r = torch.linalg.qr(A)
    return torch.linalg.solve_triangular(r, q.transpose(1, 2) @ e,
                                         upper=True)[..., 0]


def _symmetrize(M: CsrMatrix) -> CsrMatrix:
    """M <- (M + M^T) / 2."""
    S = M.to_scipy()
    return CsrMatrix.from_scipy(((S + S.T) * 0.5).tocsr())
