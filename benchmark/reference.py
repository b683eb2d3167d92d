"""The comparison that decides ``correct``, and the control that it has
to fail.

Every number here is computed against a configuration's plain
reference product (``reference_matmat`` of its matrix module, plain
torch from the benchmark's own arrays), in float64:

* a product's ``rel_err``: the largest componentwise error
  ``|Y - Y_ref| / (|A| |X|)`` over every entry of the sampled answers
  (0 where both sides are 0, infinite where only the error is not);
* a solve's ``true_resid``: the largest ``||B - A X|| / ||B||`` over the
  lanes of the sampled solves, and ``resid_gap``: the largest distance
  between that true residual and the residual the solver reported,
  over the tolerance.

The control is the reference put in the program's place one precision
below the configuration's type (``LOWER``): the reference product
itself, or ``reference_cg`` on it.
"""

from __future__ import annotations

import torch

LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
# rows of a product's answer compared at a time
RATIO_ROWS = 1 << 22


def product_rel_err(matmat, X: torch.Tensor, answers) -> float:
    """``rel_err`` of the answers (tensors like ``matmat(X)``) to the
    products of ``X``; ``matmat(V, absolute)`` is the reference. The
    ratios are taken over blocks of ``RATIO_ROWS`` rows."""
    X64 = X.to(torch.float64)
    ref = matmat(X64, False)
    den = matmat(X64, True)
    del X64
    worst = 0.0
    for Y in answers:
        for s in range(0, ref.shape[0], RATIO_ROWS):
            num = (Y[s:s + RATIO_ROWS].to(torch.float64)
                   - ref[s:s + RATIO_ROWS]).abs()
            d = den[s:s + RATIO_ROWS]
            ratio = torch.where(d > 0, num / d.clamp_min(1e-300),
                                torch.where(num > 0, float("inf"), 0.0))
            worst = max(worst, float(ratio.max()))
    return worst


def solve_residuals(matmat, B: torch.Tensor, X: torch.Tensor,
                    reported) -> tuple[torch.Tensor, torch.Tensor]:
    """(true, reported) relative residuals per lane of one solve, float64
    on the host; ``matmat(V)`` is the reference product."""
    B2 = (B.reshape(-1, 1) if B.dim() == 1 else B).to(torch.float64)
    X2 = (X.reshape(-1, 1) if X.dim() == 1 else X).to(torch.float64)
    R = B2 - matmat(X2)
    true = (R.norm(dim=0) / B2.norm(dim=0).clamp_min(1e-300)).cpu()
    rep = torch.as_tensor(reported, dtype=torch.float64).reshape(-1).cpu()
    return true, rep


def reference_cg(matmat, B: torch.Tensor, tolerance: float,
                 max_iters: int):
    """Plain CG on every column of B (n, L) in B's type, each lane
    frozen once ``||r|| / ||b|| < tolerance``. Returns (X, iterations,
    converged (L,), reported residual (L,))."""
    X = torch.zeros_like(B)
    R = B.clone()
    P = R.clone()
    rs = (R * R).sum(0)
    b_norm = torch.sqrt((B * B).sum(0))
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    zero = torch.zeros_like(rs)
    done = torch.sqrt(rs) / b_norm < tolerance
    it = 0
    while it < max_iters and not bool(done.all()):
        AP = matmat(P)
        pAp = (P * AP).sum(0)
        alpha = torch.where(done | (pAp == 0), zero, rs / pAp)
        X = X + alpha * P
        R = R - alpha * AP
        rs_new = (R * R).sum(0)
        done = done | (torch.sqrt(rs_new) / b_norm < tolerance)
        beta = torch.where(done | (rs == 0), zero, rs_new / rs)
        P = R + beta * P
        rs = rs_new
        it += 1
    return X, it, done, torch.sqrt(rs) / b_norm
