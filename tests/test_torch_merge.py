"""Merge-path SpMV (kernel K2's plain version) against the JAX package.

The JAX side is its merge plan (``strategy='merge'``, the Pallas kernel
in interpret mode on the CPU); the port's operand is the JAX host CSR
carried across (``utils/carry.py``). With u = 2^-24:

  * ``compare_results`` PASS against the float64 golden, and against
    JAX wherever the JAX value itself passes against the golden (with
    the repository's usual seed-0 input, lesmis' JAX result does not: a
    cancelled row sum; there the port must be the nearer one);
  * normwise ``max|d| <= 1e-5 * max_i (|A||x|)_i`` — the JAX kernel
    forms row sums as differences of prefix sums, which are not bounded
    row by row;
  * against the float64 golden ``spmv_numpy``:
    ``|d|_i <= (nnz_i + 2) u (|A||x|)_i``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmv as jspmv
from tpusparse_torch import CsrMatrix, plan_matrix, spmv
from tpusparse_torch.kernels import merge_spmv
from tpusparse_torch.ops.reference import spmv_numpy
from tpusparse_torch.utils.carry import plan_from_arrays
from tpusparse_torch.utils.compare import compare_results

ROOT = Path(__file__).resolve().parent.parent
U = 2.0 ** -24

FIXTURES = {
    "lap3d-12": lambda: jgen.make_laplacian_grid3d(12),
    "wheel-300": lambda: jgen.make_wheel(300),
    "rmat-10": lambda: jgen.make_rmat(10),
}
FIXTURES.update({p.stem: (lambda p=p: jread_market(p))
                 for p in sorted((ROOT / "data" / "real").glob("*.mtx"))})


def _carried(csr):
    return plan_from_arrays("csr", {
        "row_offsets": np.asarray(csr.row_offsets),
        "col_indices": np.asarray(csr.col_indices),
        "values": np.asarray(csr.values), "shape": csr.shape}, "cpu")


def _bounds(csr, x):
    """(float64 product, |A||x|, nnz per row) of the f32-valued CSR."""
    host = CsrMatrix(csr.num_rows, csr.num_cols, np.asarray(csr.row_offsets),
                     np.asarray(csr.col_indices),
                     np.asarray(csr.values, dtype=np.float32))
    absm = CsrMatrix(host.num_rows, host.num_cols, host.row_offsets,
                     host.col_indices, np.abs(host.values))
    return (spmv_numpy(host, x), spmv_numpy(absm, np.abs(x)),
            np.diff(host.row_offsets))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_k2_plain_matches_jax_merge(name):
    csr = FIXTURES[name]().to_csr()
    x = np.random.default_rng(0).standard_normal(csr.num_cols).astype(
        np.float32)
    yj = np.asarray(jspmv(jplan(csr, "merge", dtype=np.float32), x))
    M = _carried(csr)
    y = merge_spmv.spmv_merge(M, torch.from_numpy(x)).numpy()
    assert y.shape == yj.shape == (csr.num_rows,) and y.dtype == np.float32
    exact, ax, nnz_i = _bounds(csr, x)
    assert compare_results(y, exact)[0]
    ok, worst = compare_results(y, yj)
    if not compare_results(yj, exact)[0]:
        # the JAX value itself fails the comparator against the float64
        # golden (a cancelled row sum taken as a difference of prefix
        # sums); there the port must be the nearer of the two
        assert abs(y[worst] - exact[worst]) < abs(yj[worst] - exact[worst])
    else:
        assert ok, (worst, y[worst], yj[worst])
    assert np.max(np.abs(y - yj)) <= 1e-5 * ax.max()
    assert np.all(np.abs(y - exact) <= (nnz_i + 2) * U * ax)


EDGE_CASES = {
    "empty-rows": CsrMatrix(6, 5, np.array([0, 0, 2, 2, 2, 3, 3]),
                            np.array([1, 4, 0]), np.array([1.0, 2.0, 3.0])),
    "nnz-0": CsrMatrix(4, 4, np.zeros(5, np.int32), np.zeros(0, np.int32),
                       np.zeros(0)),
    "n-0": CsrMatrix(0, 3, np.zeros(1, np.int32), np.zeros(0, np.int32),
                     np.zeros(0)),
    "one-long-row": CsrMatrix(3, 5000, np.array([0, 0, 5000, 5000]),
                              np.arange(5000), np.linspace(-1, 1, 5000)),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_k2_plain_edge_cases(name):
    csr = EDGE_CASES[name]
    x = np.random.default_rng(2).standard_normal(csr.num_cols).astype(
        np.float32)
    y = spmv(plan_matrix(csr, "merge", device="cpu"), torch.from_numpy(x))
    exact, ax, nnz_i = _bounds(csr, x)
    assert y.shape == (csr.num_rows,)
    assert np.all(np.abs(y.numpy() - exact) <= (nnz_i + 2) * U * ax)


def test_own_merge_plan_equals_carried():
    csr = jgen.make_rmat(9).to_csr()
    port = plan_matrix(CsrMatrix(csr.num_rows, csr.num_cols, csr.row_offsets,
                                 csr.col_indices, csr.values), "merge",
                       device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        csr.num_cols).astype(np.float32))
    np.testing.assert_array_equal(spmv(port, x).numpy(),
                                  spmv(_carried(csr), x).numpy())
    y0 = torch.ones(csr.num_rows)
    np.testing.assert_allclose(
        spmv(port, x, alpha=2.0, beta=-1.0, y=y0).numpy(),
        2.0 * spmv(port, x).numpy() - 1.0, rtol=1e-6, atol=1e-5)


def test_wrapper_rejects_bad_operands():
    M = _carried(jgen.make_laplacian_grid2d(4).to_csr())
    # mixed types: float64 x on a float32 operand
    with pytest.raises(TypeError):
        merge_spmv.merge_matvec(M, torch.zeros(16, dtype=torch.float64))
    with pytest.raises(ValueError):
        merge_spmv.merge_matvec(M, torch.zeros(15))
    with pytest.raises(ValueError):
        merge_spmv.merge_matvec(M, torch.zeros(32)[::2])
    bad = merge_spmv.MergeDevice(16, 16, M.row_offsets.long(),
                                 M.col_indices, M.values)
    with pytest.raises(TypeError, match="int32"):
        merge_spmv.merge_matvec(bad, torch.zeros(16))
    meta = merge_spmv.MergeDevice(16, 16, M.row_offsets.to("meta"),
                                  M.col_indices.to("meta"),
                                  M.values.to("meta"))
    with pytest.raises(ValueError, match="no K2 path"):
        merge_spmv.merge_matvec(meta, torch.zeros(16, device="meta"))
    with pytest.raises(ValueError, match="same device"):
        merge_spmv.merge_matvec(meta, torch.zeros(16))
