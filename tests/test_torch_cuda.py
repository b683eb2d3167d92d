"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and skip without one. They import no JAX; on a machine with a card and
no JAX, run them without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse_torch import (
    CsrMatrix,
    cg_solve,
    cg_solve_bf16,
    cg_solve_multi,
    cg_solve_multi_refined,
    cg_solve_multi_refined_f32,
    cg_solve_refined,
    plan_dia_bf16,
    plan_kind,
    plan_matrix,
    spmm,
    spmv,
)
from tpusparse_torch.formats.dia import (
    DiaDevice,
    partition_dia,
    select_diagonals,
    to_device_dia,
)
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.kernels import (
    dia_stream,
    ell_spmm,
    merge_spmv,
    spmm_merge,
)
from tpusparse_torch.ops.reference import csr_matmat, csr_matvec

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
U = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _x(n, seed, dev, shape=None):
    x = np.random.default_rng(seed).standard_normal(shape or n)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("L", [1, 4])
def test_k1_matches_plain(cuda, L):
    csr = gen.make_laplacian_grid3d(16).to_csr()
    D = plan_matrix(csr, "auto", device=cuda).dia
    XT = _x(None, L, cuda, (L, csr.num_cols))
    before = dia_stream.LAUNCHES
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    assert dia_stream.LAUNCHES == before + 1
    Yp = dia_stream.spmm_dia_masked_plain(D, XT)
    absD = dia_stream.from_mask_words(D.num_rows, D.num_cols, D.offsets,
                                      D.vals.abs().cpu().numpy(),
                                      D.mask.cpu().numpy(), cuda)
    AX = dia_stream.spmm_dia_masked_plain(absD, XT.abs().double())
    assert torch.all((Y - Yp).abs().double() <= 2 * len(D.offsets) * U * AX)


CASES = {
    "wheel-5000": lambda: gen.make_wheel(5000).to_csr(),
    "rmat-12": lambda: gen.make_rmat(12).to_csr(),
    "bibd_9_3": lambda: read_market(ROOT / "data/real/bibd_9_3.mtx").to_csr(),
    "empty-rows": lambda: CsrMatrix(6, 5, np.array([0, 0, 2, 2, 2, 3, 3]),
                                    np.array([1, 4, 0]),
                                    np.array([1.0, 2.0, 3.0])),
    "nnz-0": lambda: CsrMatrix(4, 4, np.zeros(5, np.int32),
                               np.zeros(0, np.int32), np.zeros(0)),
    "n-0": lambda: CsrMatrix(0, 3, np.zeros(1, np.int32),
                             np.zeros(0, np.int32), np.zeros(0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_k2_matches_float64_and_repeats_bitwise(cuda, name):
    M = merge_spmv.to_device_merge(CASES[name](), cuda)
    x = _x(M.num_cols, 5, cuda)
    y1 = merge_spmv.merge_matvec(M, x)
    y2 = merge_spmv.merge_matvec(M, x)
    assert torch.equal(y1, y2) and y1.shape == (M.num_rows,)
    args = (M.num_rows, M.row_offsets, M.col_indices)
    y64 = csr_matvec(*args, M.values.double(), x.double())
    ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
    nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()
    assert torch.all((y1.double() - y64).abs() <= (nnz_i + 2) * U * ax)


def test_cg_on_card_matches_cpu(cuda):
    csr = gen.make_laplacian_grid3d(12).to_csr()
    b = _x(csr.num_rows, 1, "cpu")
    r_cpu = cg_solve(plan_matrix(csr, "auto", device="cpu"), b)
    before = dia_stream.LAUNCHES
    r = cg_solve(plan_matrix(csr, "auto", device=cuda), b.to(cuda))
    assert dia_stream.LAUNCHES > before
    assert r.converged and abs(r.iterations - r_cpu.iterations) <= 1
    assert torch.linalg.norm(r.x.cpu() - r_cpu.x) \
        <= 1e-4 * torch.linalg.norm(r_cpu.x)


def test_no_fallback_on_cuda_tensors(cuda):
    csr = gen.make_laplacian_grid2d(4).to_csr()
    A = plan_matrix(csr, "auto", device=cuda)
    # mixed types: float64 XT on a float32 operand
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_stream_t(A.dia, torch.zeros(1, 16, device=cuda,
                                                        dtype=torch.float64))
    M = plan_matrix(csr, "merge", device=cuda)
    with pytest.raises(ValueError, match="same device"):
        merge_spmv.merge_matvec(M, torch.zeros(16))
    y = spmv(M, torch.ones(16, device=cuda))
    assert y.is_cuda


# (plan, kernel wrapper, plain version, kernel module) of K3 and K4
SPMM_KERNELS = {
    "K3": (merge_spmv.to_device_merge, spmm_merge.merge_matmat,
           spmm_merge.spmm_merge_plain, spmm_merge),
    "K4": (ell_spmm.to_device_row_split, ell_spmm.row_split_matmat,
           ell_spmm.spmm_row_split_plain, ell_spmm),
}


@pytest.mark.parametrize("L", [1, 3, 16, 40])
@pytest.mark.parametrize("kernel", list(SPMM_KERNELS))
@pytest.mark.parametrize("name", list(CASES))
def test_spmm_kernels_match_plain_and_float64(cuda, name, kernel, L):
    plan, matmat, plain, module = SPMM_KERNELS[kernel]
    A = plan(CASES[name](), cuda)
    X = _x(None, 7, cuda, (A.num_cols, L))
    before = module.LAUNCHES
    Y1 = matmat(A, X)
    Y2 = matmat(A, X)
    assert module.LAUNCHES == before + (2 if A.num_rows else 0)
    assert Y1.shape == (A.num_rows, L) and torch.equal(Y1, Y2)
    args = (A.num_rows, A.row_offsets, A.col_indices)
    Y64 = csr_matmat(*args, A.values.double(), X.double())
    AX = csr_matmat(*args, A.values.abs().double(), X.abs().double())
    nnz_i = (A.row_offsets[1:] - A.row_offsets[:-1]).double()[:, None]
    assert torch.all((Y1.double() - Y64).abs() <= (nnz_i + 2) * U * AX)
    Yp = plain(A, X)
    if Y1.numel():
        assert float((Y1 - Yp).abs().max()) <= 1e-5 * float(AX.max())


@pytest.mark.parametrize("name,make,kind", [
    ("lap3d-16", lambda: gen.make_laplacian_grid3d(16).to_csr(), "dia"),
    ("wheel-5000", CASES["wheel-5000"], "hybrid_dia"),
    ("rmat-12", CASES["rmat-12"], "merge")])
def test_auto_spmm_on_card_matches_float64(cuda, name, make, kind):
    csr = make()
    P = plan_matrix(csr, "auto", L=8, device=cuda)
    assert plan_kind(P) == kind
    X = _x(None, 3, cuda, (csr.num_cols, 8))
    Y = spmm(P, X)
    C = csr.to(cuda)
    args = (C.num_rows, C.row_offsets, C.col_indices)
    Y64 = csr_matmat(*args, C.values.double(), X.double())
    AX = csr_matmat(*args, C.values.abs().double(), X.abs().double())
    nnz_i = (C.row_offsets[1:] - C.row_offsets[:-1]).double()[:, None]
    # a hybrid row sums its DIA part and its remainder separately: one
    # more rounding than a single pass over the row
    assert torch.all((Y.double() - Y64).abs() <= (nnz_i + 3) * U * AX)


def test_cg_multi_on_card_matches_cpu(cuda):
    csr = gen.make_laplacian_grid3d(12).to_csr()
    B = _x(None, 2, "cpu", (csr.num_rows, 4))
    for strategy, module in (("auto", dia_stream), ("merge", spmm_merge),
                             ("row_split", ell_spmm)):
        r_cpu = cg_solve_multi(plan_matrix(csr, strategy, L=4, device="cpu"),
                               B)
        before = module.LAUNCHES
        r = cg_solve_multi(plan_matrix(csr, strategy, L=4, device=cuda),
                           B.to(cuda))
        assert module.LAUNCHES > before
        assert bool(r.converged.all()) and bool(r_cpu.converged.all())
        assert abs(r.iterations - r_cpu.iterations) <= 1
        assert torch.all(torch.linalg.norm(r.x.cpu() - r_cpu.x, dim=0)
                         <= 1e-4 * torch.linalg.norm(r_cpu.x, dim=0))


def _planes(csr, dev, plane_dtype=torch.float32):
    host, rest = partition_dia(csr, select_diagonals(csr))
    assert rest.nnz == 0
    return to_device_dia(host, dev, plane_dtype)


def _band(n, m, offsets, seed):
    """n x m band with random values on ``offsets``."""
    rng = np.random.default_rng(seed)
    A = sp.diags([rng.uniform(-2, 2, min(n, m - o) - max(0, -o))
                  for o in offsets], offsets, shape=(n, m)).tocsr()
    return CsrMatrix(n, m, A.indptr, A.indices, A.data.astype(np.float32))


PLANE_CASES = {
    "var-7-12": lambda: gen.make_variable_stencil(12).to_csr(),
    "var-27-8": lambda: gen.make_variable_stencil(8, full=True,
                                                  seed=2).to_csr(),
    "Trefethen_200": lambda: read_market(
        ROOT / "data/real/Trefethen_200.mtx").to_csr(),
    "rect-300x305": lambda: _band(300, 305, [-7, 0, 3, 5], 1),
    "neg-only": lambda: _band(200, 200, [-150, -11], 2),
}


@pytest.mark.parametrize("L", [1, 4, 16])
@pytest.mark.parametrize("plane_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(PLANE_CASES))
def test_k5_matches_plain_bitwise(cuda, name, plane_dtype, L):
    D = _planes(PLANE_CASES[name](), cuda, plane_dtype)
    XT = _x(None, L, cuda, (L, D.num_cols))
    before = dia_stream.PLANES_LAUNCHES
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    assert dia_stream.PLANES_LAUNCHES == before + 1
    assert Y.shape == (L, D.num_rows) and Y.device == XT.device
    assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))
    absD = dataclasses.replace(D, data=D.data.abs())
    AX = dia_stream.spmm_dia_planes_plain(absD, XT.abs().double())
    exact = dia_stream.spmm_dia_planes_plain(D, XT.double())
    assert torch.all((Y.double() - exact).abs()
                     <= len(D.offsets) * U * AX * 1.01)


def test_k5_empty_operands_launch_nothing(cuda):
    D = _planes(PLANE_CASES["var-7-12"](), cuda)
    before = dia_stream.PLANES_LAUNCHES
    Y = dia_stream.spmm_dia_planes_t(
        D, torch.zeros(0, D.num_cols, device=cuda))
    assert Y.shape == (0, D.num_rows)
    E = DiaDevice(0, 5, (0, 2), torch.zeros(2, 0, device=cuda))
    assert dia_stream.spmm_dia_planes_t(
        E, torch.ones(3, 5, device=cuda)).shape == (3, 0)
    Z = DiaDevice(4, 4, (), torch.zeros(0, 4, device=cuda))
    assert torch.equal(dia_stream.spmm_dia_planes_t(
        Z, torch.ones(2, 4, device=cuda)), torch.zeros(2, 4, device=cuda))
    assert dia_stream.PLANES_LAUNCHES == before


def test_k5_no_fallback_on_cuda_tensors(cuda):
    D = _planes(PLANE_CASES["var-7-12"](), cuda)
    n = D.num_rows
    # mixed types: float64 XT on float32 planes
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_planes_t(
            D, torch.zeros(1, n, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="same device"):
        dia_stream.spmm_dia_planes_t(D, torch.zeros(1, n))
    before = dia_stream.PLANES_LAUNCHES
    y = spmv(plan_matrix(gen.make_variable_stencil(12).to_csr(), "auto",
                         device=cuda), torch.ones(n, device=cuda))
    assert y.is_cuda and dia_stream.PLANES_LAUNCHES == before + 1


def test_k5_equals_k1_on_constant_band(cuda):
    csr = gen.make_laplacian_grid3d(16).to_csr()
    D1 = plan_matrix(csr, "auto", device=cuda).dia
    D5 = _planes(csr, cuda)
    XT = _x(None, 4, cuda, (4, csr.num_cols))
    assert torch.equal(dia_stream.spmm_dia_stream_t(D1, XT),
                       dia_stream.spmm_dia_planes_t(D5, XT))


def test_variable_band_solvers_on_card_match_cpu(cuda):
    csr = gen.make_variable_stencil(8, full=True, seed=2,
                                    shift=1.0).to_csr()
    b = _x(csr.num_rows, 4, "cpu")
    B = _x(None, 5, "cpu", (csr.num_rows, 4))
    plans = {dev: (plan_matrix(csr, "auto", device=dev),
                   plan_dia_bf16(csr, device=dev)) for dev in ("cpu", cuda)}
    before = dia_stream.PLANES_LAUNCHES
    runs = {dev: (cg_solve(A32, b.to(dev)), cg_solve_multi(A32, B.to(dev)),
                  cg_solve_bf16(A16, A32, b.to(dev)),
                  cg_solve_multi_refined_f32(A16, A32, B.to(dev)))
            for dev, (A32, A16) in plans.items()}
    assert dia_stream.PLANES_LAUNCHES > before
    (c1, cm, c16, cr), (g1, gm, g16, gr) = runs["cpu"], runs[cuda]
    assert plan_kind(plans[cuda][0]) == "dia"
    assert plan_kind(plans[cuda][1]) == "dia_bf16"
    assert g1.converged and abs(g1.iterations - c1.iterations) <= 1
    assert bool(gm.converged.all()) and abs(gm.iterations - cm.iterations) <= 1
    assert g16.converged and abs(g16.iterations - c16.iterations) <= 2
    assert gr.refinements == cr.refinements
    for g, c in ((g1, c1), (gm, cm), (g16, c16), (gr, cr)):
        assert torch.linalg.norm(g.x.cpu() - c.x) \
            <= 1e-4 * torch.linalg.norm(c.x)


@pytest.mark.parametrize("kernel", list(SPMM_KERNELS))
def test_spmm_kernels_refuse_wrong_operands(cuda, kernel):
    plan, matmat, _, _ = SPMM_KERNELS[kernel]
    A = plan(gen.make_laplacian_grid2d(4).to_csr(), cuda)
    # mixed types: float64 X on a float32 operand
    with pytest.raises(TypeError):
        matmat(A, torch.zeros(16, 3, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="same device"):
        matmat(A, torch.zeros(16, 3))
    Y = spmm(A, torch.ones(16, 3, device=cuda))
    assert Y.is_cuda and Y.shape == (16, 3)


# float64 twins K1d-K5d; u = 2^-53
U64 = 2.0 ** -53


def _x64(seed, dev, shape):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("L", [1, 4, 16])
def test_k1d_matches_plain_bitwise(cuda, L):
    csr = gen.make_laplacian_grid3d(16).to_csr()
    D = plan_matrix(csr, "auto", dtype=np.float64, device=cuda).dia
    assert isinstance(D, dia_stream.DiaStreamDevice)
    XT = _x64(L, cuda, (L, csr.num_cols))
    before, before32 = dia_stream.LAUNCHES_F64, dia_stream.LAUNCHES
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    assert dia_stream.LAUNCHES_F64 == before + 1
    assert dia_stream.LAUNCHES == before32
    assert Y.dtype == torch.float64 and Y.shape == (L, csr.num_cols)
    assert torch.equal(Y, dia_stream.spmm_dia_masked_plain(D, XT))
    assert torch.equal(Y, dia_stream.spmm_dia_stream_t(D, XT))


@pytest.mark.parametrize("L", [1, 4, 16])
@pytest.mark.parametrize("name", list(PLANE_CASES))
def test_k5d_matches_plain_bitwise(cuda, name, L):
    D = _planes(PLANE_CASES[name](), cuda, torch.float64)
    XT = _x64(L, cuda, (L, D.num_cols))
    before = dia_stream.PLANES_LAUNCHES_F64
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    assert dia_stream.PLANES_LAUNCHES_F64 == before + 1
    assert Y.dtype == torch.float64 and Y.shape == (L, D.num_rows)
    assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))
    assert torch.equal(Y, dia_stream.spmm_dia_planes_t(D, XT))


@pytest.mark.parametrize("L", [1, 16])
def test_k5d_at_64_planes(cuda, L):
    """64 float64 planes stage a 64 KiB coefficient tile: past the
    default 48 KiB of dynamic shared memory a launch gets."""
    A = _band(600, 640, list(range(-40, 24)), 9)
    host, rest = partition_dia(A, np.arange(-40, 24))
    assert rest.nnz == 0
    D = to_device_dia(host, cuda, torch.float64)
    assert len(D.offsets) == 64
    XT = _x64(L + 1, cuda, (L, D.num_cols))
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    torch.cuda.synchronize()
    assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("kernel", list(SPMM_KERNELS))
@pytest.mark.parametrize("name", list(CASES))
def test_fp64_csr_kernels_match_plain(cuda, name, kernel, L):
    """K3d and K4d (and K2d at L = 1) against their plain versions:
    within 2 (nnz_i + 2) u (|A||X|), and two runs bitwise equal."""
    plan, matmat, plain, module = SPMM_KERNELS[kernel]
    csr = CASES[name]()
    A = plan(csr, cuda, torch.float64)
    X = _x64(11, cuda, (A.num_cols, L))
    before = module.LAUNCHES_F64
    Y1, Y2 = matmat(A, X), matmat(A, X)
    assert module.LAUNCHES_F64 == before + (2 if A.num_rows else 0)
    assert Y1.dtype == torch.float64 and torch.equal(Y1, Y2)
    args = (A.num_rows, A.row_offsets, A.col_indices)
    AX = csr_matmat(*args, A.values.abs(), X.abs())
    nnz_i = (A.row_offsets[1:] - A.row_offsets[:-1]).double()[:, None]
    assert torch.all((Y1 - plain(A, X)).abs()
                     <= 2 * (nnz_i + 2) * U64 * AX)
    if kernel == "K3" and L == 1:
        M = merge_spmv.to_device_merge(csr, cuda, torch.float64)
        before = merge_spmv.LAUNCHES_F64
        y1, y2 = merge_spmv.merge_matvec(M, X[:, 0]), \
            merge_spmv.merge_matvec(M, X[:, 0])
        assert merge_spmv.LAUNCHES_F64 == before + (2 if M.num_rows else 0)
        assert torch.equal(y1, y2)
        assert torch.all((y1 - merge_spmv.spmv_merge_plain(M, X[:, 0])).abs()
                         <= 2 * (nnz_i[:, 0] + 2) * U64 * AX[:, 0])


def test_fp64_kernels_refuse_mixed_types(cuda):
    csr = gen.make_laplacian_grid2d(4).to_csr()
    n = csr.num_rows
    for dtype, other in ((torch.float64, torch.float32),
                         (torch.float32, torch.float64)):
        host, _ = partition_dia(csr, select_diagonals(csr))
        D1 = dia_stream.to_device_dia_stream(host, cuda, dtype)
        D5 = to_device_dia(host, cuda, dtype)
        with pytest.raises(TypeError):
            dia_stream.spmm_dia_stream_t(D1, torch.zeros(1, n, device=cuda,
                                                         dtype=other))
        with pytest.raises(TypeError):
            dia_stream.spmm_dia_planes_t(D5, torch.zeros(1, n, device=cuda,
                                                         dtype=other))
        M = merge_spmv.to_device_merge(csr, cuda, dtype)
        with pytest.raises(TypeError):
            merge_spmv.merge_matvec(M, torch.zeros(n, device=cuda,
                                                   dtype=other))
        for kernel, (plan, matmat, _, _) in SPMM_KERNELS.items():
            with pytest.raises(TypeError):
                matmat(plan(csr, cuda, dtype),
                       torch.zeros(n, 2, device=cuda, dtype=other))


def test_fp64_solvers_on_card_match_cpu(cuda):
    csr = gen.make_variable_stencil(8, shift=1.0).to_csr()
    b = _x64(21, "cpu", csr.num_rows)
    B = _x64(22, "cpu", (csr.num_rows, 4))
    out = {}
    for dev in ("cpu", cuda):
        A64 = plan_matrix(csr, "auto", dtype=np.float64, device=dev)
        A32 = plan_matrix(csr, "auto", device=dev)
        out[dev] = (cg_solve(A64, b.to(dev), tolerance=1e-10),
                    cg_solve_multi(A64, B.to(dev), tolerance=1e-10),
                    cg_solve_refined(A32, A64, b.to(dev)),
                    cg_solve_multi_refined(A32, A64, B.to(dev)))
    (c1, cm, cr, cmr), (g1, gm, gr, gmr) = out["cpu"], out[cuda]
    assert g1.converged and abs(g1.iterations - c1.iterations) <= 1
    assert bool(gm.converged.all()) and abs(gm.iterations - cm.iterations) <= 1
    assert gr.refinements == cr.refinements and float(gr.residual) < 1e-12
    assert gmr.refinements == cmr.refinements
    assert float(gmr.residual.max()) < 1e-12
    for g, c in ((g1, c1), (gm, cm), (gr, cr), (gmr, cmr)):
        assert g.x.dtype == torch.float64
        assert torch.linalg.norm(g.x.cpu() - c.x) \
            <= 1e-8 * torch.linalg.norm(c.x)
