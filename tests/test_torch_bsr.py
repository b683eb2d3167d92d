"""The port's BCSR host layer and BSR panel SpMM (K8, K8d) against the
JAX package.

Both packages get the same host matrices and numpy-seeded right-hand
sides. The JAX side runs B6 (``tpusparse/kernels/bsr.py``) as its own
tests do, in Pallas interpret mode on the CPU, and its float64 einsum
path; the port runs K8's plain version.

  * host layer: ``BcsrMatrix.from_csr`` / ``to_csr``, ``fill_ratio``,
    ``fill_estimate`` and ``make_block_random`` give the JAX package's
    arrays;
  * K8's plain version against B6 at L = 1 and 16:
    |dY|_il <= 2 (w_i + 2) u (|A||X|)_il, w_i the stored entries of row
    i (bc per block of its block row), u = 2^-24, and normwise 1e-5;
  * the float64 plain version against the JAX float64 ``bsr_spmm`` with
    (4, 8) blocks: 1e-12 relative;
  * ``plan_matrix(csr, 'bsr')`` and the ``bsr`` carry give JAX's Y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.formats.bcsr import BcsrMatrix as JBcsr
from tpusparse.formats.bcsr import fill_estimate as jfill_estimate
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.io import generators as jgen
from tpusparse.kernels import bsr as jbsr
from tpusparse.ops.spmv import plan_kind as jplan_kind
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse_torch import CsrMatrix, plan_kind, plan_matrix, spmm, spmv
from tpusparse_torch.bench.models import bsr_bytes, bsr_flops
from tpusparse_torch.formats.bcsr import BcsrMatrix, fill_estimate
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import bsr
from tpusparse_torch.utils.carry import plan_from_arrays

U = 2.0 ** -24


def _port(j) -> CsrMatrix:
    return CsrMatrix(j.num_rows, j.num_cols, np.asarray(j.row_offsets),
                     np.asarray(j.col_indices), np.asarray(j.values))


def _edge():
    """make_block_random(20, 3) cut to 155 x 2500: partial edge blocks
    in both dimensions, and block row 2 (rows 16-23) emptied."""
    S = jgen.make_block_random(20, 3, seed=4).to_csr().to_scipy()
    S = S[:155, :2500].tolil()
    S[16:24, :] = 0
    return JCsr.from_scipy(sp.csr_matrix(S))


def _empty():
    return JCsr(24, 300, np.zeros(25, np.int32), np.zeros(0, np.int32),
                np.zeros(0))


# name -> (JAX host CSR, block shape)
HOST = {
    "block-8x3": (lambda: jgen.make_block_random(8, 3).to_csr(), (8, 128)),
    "block-6x2-fill0.3": (lambda: jgen.make_block_random(
        6, 2, fill=0.3, seed=2).to_csr(), (8, 128)),
    "edge-155x2500": (_edge, (8, 128)),
    "nnz-0": (_empty, (8, 128)),
    "lap2d-12-4x8": (lambda: jgen.make_laplacian_grid2d(12).to_csr(),
                     (4, 8)),
}


@pytest.mark.parametrize("name", list(HOST))
def test_bcsr_host_layer_equals_jax(name):
    make, (br, bc) = HOST[name]
    j = make()
    jb = JBcsr.from_csr(j, br, bc)
    b = BcsrMatrix.from_csr(_port(j), br, bc)
    for a, ja in ((b.block_row_offsets, jb.block_row_offsets),
                  (b.block_col_indices, jb.block_col_indices),
                  (b.blocks, jb.blocks)):
        np.testing.assert_array_equal(a, np.asarray(ja))
        assert a.dtype == np.asarray(ja).dtype
    assert (b.num_blocks, b.num_block_rows, b.num_block_cols, b.shape) == \
        (jb.num_blocks, jb.num_block_rows, jb.num_block_cols, jb.shape)
    assert b.fill_ratio == jb.fill_ratio
    assert fill_estimate(_port(j), br, bc) == jfill_estimate(j, br, bc)
    c, jc = b.to_csr(), jb.to_csr()
    for a, ja in ((c.row_offsets, jc.row_offsets),
                  (c.col_indices, jc.col_indices), (c.values, jc.values)):
        np.testing.assert_array_equal(a, np.asarray(ja))


@pytest.mark.parametrize("kw", [
    {"block_grid": 8, "blocks_per_row": 3},
    {"block_grid": 6, "blocks_per_row": 2, "fill": 0.3, "seed": 2},
    {"block_grid": 5, "blocks_per_row": 9, "block_rows": 4,
     "block_cols": 16, "seed": 7},
])
def test_make_block_random_equals_jax(kw):
    a, ja = gen.make_block_random(**kw), jgen.make_block_random(**kw)
    assert a.shape == ja.shape
    for x, y in ((a.rows, ja.rows), (a.cols, ja.cols), (a.vals, ja.vals)):
        np.testing.assert_array_equal(x, np.asarray(y))


def _row_bound(A, X, u=U):
    """(float64 A X, 2 (w_i + 2) u |A||X|, |A||X|) on the BCSR ``A``."""
    Ad = BcsrMatrix(A.num_rows, A.num_cols, A.block_rows, A.block_cols,
                    A.block_row_offsets, A.block_col_indices,
                    A.blocks.double())
    X64 = torch.as_tensor(X).double()
    Y64 = bsr.bsr_spmm_plain(Ad, X64)
    Ad.blocks = Ad.blocks.abs()
    AX = bsr.bsr_spmm_plain(Ad, X64.abs())
    per_brow = (A.block_row_offsets[1:] - A.block_row_offsets[:-1]).double()
    w = (per_brow * A.block_cols).repeat_interleave(A.block_rows)
    w = w[:A.num_rows, None]
    return Y64.numpy(), (2 * (w + 2) * u * AX).numpy(), AX.numpy()


@pytest.mark.parametrize("L", [1, 16])
@pytest.mark.parametrize("grid", [(8, 3), (6, 2)])
def test_k8_plain_matches_b6(grid, L):
    j = jgen.make_block_random(*grid).to_csr()
    j32 = j.astype(np.float32)
    jb = JBcsr.from_csr(j32, 8, 128).to_device()
    assert jbsr._tileable(jb)
    A = plan_matrix(_port(j), "bsr", device="cpu", dtype=np.float32)
    assert plan_kind(A) == "bsr" and A.blocks.dtype == torch.float32
    X = np.random.default_rng(L).standard_normal(
        (j.num_cols, L)).astype(np.float32)
    Yj = np.asarray(jbsr.bsr_spmm_pallas(jb, jnp.asarray(X)))
    Y = bsr.bsr_matmat(A, torch.from_numpy(X)).numpy()
    assert Y.shape == (j.num_rows, L) and Y.dtype == np.float32
    _, bound, AX = _row_bound(A, X)
    assert np.all(np.abs(Y.astype(np.float64) - Yj) <= bound)
    assert np.abs(Y - Yj).max() <= 1e-5 * AX.max()


def test_float64_plain_matches_jax_float64_bsr():
    """K8d's plain version against the JAX package's float64 product
    (XLA's einsum; ``TestBsr``), (4, 8) blocks on lap2d-12."""
    j = jgen.make_laplacian_grid2d(12).to_csr()
    jb = JBcsr.from_csr(j, 4, 8).to_device()
    A = BcsrMatrix.from_csr(_port(j), 4, 8).to("cpu", torch.float64)
    X = np.random.default_rng(3).standard_normal((j.num_cols, 8))
    Yj = np.asarray(jbsr.bsr_spmm(jb, jnp.asarray(X)))
    Y = bsr.bsr_matmat(A, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, Yj, rtol=1e-12)
    np.testing.assert_allclose(Y, j.to_scipy() @ X, rtol=1e-12)


@pytest.mark.parametrize("name", ["edge-155x2500", "nnz-0"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_plan_edges_match_scipy(name, dtype):
    """Partial edge blocks, an empty block row and nnz = 0 through
    ``spmm`` / ``spmv`` on a 'bsr' plan in either type (K8d's plain
    version in float64)."""
    j = HOST[name][0]()
    A = plan_matrix(_port(j), "bsr", dtype=dtype, device="cpu")
    assert plan_kind(A) == "bsr"
    X = np.random.default_rng(5).standard_normal((j.num_cols, 3))
    Y = spmm(A, torch.from_numpy(X)).numpy()
    assert Y.dtype == dtype and Y.shape == (j.num_rows, 3)
    Y64, bound, _ = _row_bound(A, X.astype(dtype),
                               U if dtype == np.float32 else 2.0 ** -53)
    assert np.all(np.abs(Y - Y64) <= bound)
    if name == "edge-155x2500":
        assert np.all(Y[16:24] == 0)
    y = spmv(A, torch.from_numpy(np.ascontiguousarray(X[:, 0]))).numpy()
    np.testing.assert_array_equal(y, Y[:, 0])


def test_bsr_plan_alpha_beta_and_jax_plan_kind():
    j = jgen.make_block_random(6, 2).to_csr().astype(np.float32)
    jA = jplan(j, "bsr", dtype=np.float32)
    A = plan_matrix(_port(j), "bsr", device="cpu", dtype=np.float32)
    assert plan_kind(A) == jplan_kind(jA) == "bsr"
    X = np.random.default_rng(8).standard_normal(
        (j.num_cols, 4)).astype(np.float32)
    Y0 = np.random.default_rng(9).standard_normal(
        (j.num_rows, 4)).astype(np.float32)
    Yj = np.asarray(jspmm(jA, jnp.asarray(X), alpha=2.0, beta=0.5,
                          Y=jnp.asarray(Y0)))
    Y = spmm(A, torch.from_numpy(X), alpha=2.0, beta=0.5,
             Y=torch.from_numpy(Y0)).numpy()
    _, bound, _ = _row_bound(A, X)
    assert np.all(np.abs(Y - Yj) <= 2 * bound + 4 * U * np.abs(Yj))
    # AUTO never plans BSR (the JAX fill gate waits for a card A/B)
    assert plan_kind(plan_matrix(_port(j), "auto", L=16, device="cpu",
                                 dtype=np.float32)) \
        != "bsr"


@pytest.mark.parametrize("dtype", [None, np.float64])
def test_bsr_carry_gives_jax_y(dtype):
    j = jgen.make_block_random(8, 3).to_csr()
    jb = JBcsr.from_csr(j.astype(np.float32), 8, 128).to_device()
    A = plan_from_arrays("bsr", {
        "block_row_offsets": np.asarray(jb.block_row_offsets),
        "block_col_indices": np.asarray(jb.block_col_indices),
        "blocks": np.asarray(jb.blocks), "shape": jb.shape}, "cpu", dtype)
    assert plan_kind(A) == "bsr"
    assert A.blocks.dtype == (torch.float64 if dtype else torch.float32)
    X = np.random.default_rng(11).standard_normal(
        (j.num_cols, 16)).astype(np.float32)
    Y = spmm(A, torch.from_numpy(X)).numpy()
    Yj = np.asarray(jbsr.bsr_spmm_pallas(jb, jnp.asarray(X)))
    _, bound, _ = _row_bound(A, X)
    assert np.all(np.abs(Y - Yj) <= bound)


def test_k8_wrapper_rejects_bad_operands():
    j = jgen.make_block_random(4, 2).to_csr()
    A = plan_matrix(_port(j), "bsr", device="cpu", dtype=np.float32)
    X = torch.zeros(j.num_cols, 2)
    with pytest.raises(TypeError):
        bsr.bsr_matmat(A, X.double())
    with pytest.raises(ValueError):
        bsr.bsr_matmat(A, torch.zeros(j.num_cols + 1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        bsr.bsr_matmat(A, torch.zeros(2, j.num_cols).T)
    with pytest.raises(ValueError, match="same device"):
        bsr.bsr_matmat(A, torch.zeros(j.num_cols, 2, device="meta"))
    big = BcsrMatrix(8, 1 << 20, 8, 1 << 18,
                     torch.zeros(2, dtype=torch.int32),
                     torch.zeros(0, dtype=torch.int32),
                     torch.zeros((0, 8, 1 << 18)))
    with pytest.raises(ValueError, match="blocks of 1 to"):
        bsr.bsr_matmat(big, torch.zeros(1 << 20, 1))


def test_bsr_models():
    # 2 blocks of (8, 128) over 16 x 256, L = 4
    assert bsr_bytes(2, 8, 128, 16, 256, 4) == \
        2 * (8 * 128 * 4 + 4) + 3 * 4 + (256 + 16) * 4 * 4
    assert bsr_bytes(2, 8, 128, 16, 256, 1, 8) == \
        2 * (8 * 128 * 8 + 4) + 3 * 4 + (256 + 16) * 8
    assert bsr_flops(2, 8, 128, 4) == 2 * 2 * 8 * 128 * 4
