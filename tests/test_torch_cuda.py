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
    _build,
    dia_stream,
    ell_spmm,
    merge_spmv,
    spmm_merge,
)
from tpusparse_torch.ops.reference import csr_matmat, csr_matvec
from tpusparse_torch.ops.reorder import ReorderedPlan
from tpusparse_torch.utils import trace
from test_torch_cg_lookahead import (
    assert_same_solve,
    eager_cg,
    lookahead_counts,
)
from test_torch_dia_masked_tiles import K1_CASES, emulate_k1
from test_torch_dia_planes_tiles import K5_CASES, emulate_k5
from test_torch_merge_spmm_tiles import K3_CASES, emulate_k3, integer_valued
from test_torch_nmajor_tiles import emulate_k7
from test_torch_permute_tiles import emulate_k6
from test_torch_trace import _hpcg27, tracer  # noqa: F401 (a fixture)

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
    D = plan_matrix(csr, "auto", device=cuda, dtype=np.float32).dia
    XT = _x(None, L, cuda, (L, csr.num_cols))
    before = _build.LAUNCHES["K1"]
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    assert _build.LAUNCHES["K1"] == before + 1
    Yp = dia_stream.spmm_dia_masked_plain(D, XT)
    absD = dia_stream.from_mask_words(D.num_rows, D.num_cols, D.offsets,
                                      D.vals.abs().cpu().numpy(),
                                      D.mask.cpu().numpy(), cuda)
    AX = dia_stream.spmm_dia_masked_plain(absD, XT.abs().double())
    assert torch.all((Y - Yp).abs().double() <= 2 * len(D.offsets) * U * AX)
    assert torch.equal(Y, Yp)


def _on(D, dev):
    """A CPU masked operand on ``dev``, its offset groups kept."""
    return dataclasses.replace(D, vals=D.vals.to(dev), mask=D.mask.to(dev))


def _k1_operands(name, dtype, L, dev, shift=0):
    """(D on dev, XT on dev, XT's storage offset modulo a copy): XT is
    a contiguous view ``shift`` elements into a fresh buffer."""
    D = _on(K1_CASES[name](dtype), dev)
    x = np.random.default_rng(40 + L).standard_normal((L, D.num_cols))
    buf = torch.zeros(L * D.num_cols + shift, dtype=dtype, device=dev)
    XT = buf[shift:].view(L, D.num_cols)
    XT.copy_(torch.from_numpy(x))
    V = dia_stream.k1_geometry(XT.element_size())[2]
    return D, XT, (XT.data_ptr() // XT.element_size()) % V


@pytest.mark.parametrize("L", [0, 1, 3, 16, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_bitwise_on_edge_cases(cuda, name, dtype, L):
    """K1 (K1d) equals its plain version and ``emulate_k1`` bit for bit
    on lap3d, lap2d's offsets at odd n, a 32-plane band with bit 31, 32
    spaced planes, offsets past n, K = 0, n below a row block and n = 0;
    also on an XT view whose storage starts one element past a 16-byte
    boundary."""
    counter = "K1d" if dtype == torch.float64 else "K1"
    for shift in (0, 1):
        D, XT, base = _k1_operands(name, dtype, L, cuda, shift)
        before = _build.LAUNCHES[counter]
        Y = dia_stream.spmm_dia_stream_t(D, XT)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[counter] == before + 1
        assert Y.dtype == dtype and Y.shape == (L, D.num_rows)
        assert torch.equal(Y, dia_stream.spmm_dia_masked_plain(D, XT))
        np.testing.assert_array_equal(
            Y.cpu().numpy(), emulate_k1(D, XT.cpu().numpy(), base))


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_reads_the_27_point_band_by_runs(cuda, tracer, dtype, L):
    """K1 (K1d) on HPCG's 27-point band at 24^3 (several row blocks and
    grid planes: nine runs of three planes) equals its plain version and
    ``emulate_k1`` bit for bit, and adds the 18 reads its windows replace
    to ``dia.runs`` a launch."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    D = plan_matrix(_hpcg27(24), "auto", dtype=np_dtype, device=cuda).dia
    assert D.runs == (3,) * 9
    x = np.random.default_rng(60 + L).standard_normal((L, D.num_cols))
    XT = torch.from_numpy(x).to(dtype).to(cuda)
    counter = "K1d" if dtype == torch.float64 else "K1"
    before = _build.LAUNCHES[counter]
    tracer.take()
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    _, counters = tracer.take()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert sum(counters["dia.runs"].values()) == 18
    assert torch.equal(Y, dia_stream.spmm_dia_masked_plain(D, XT))
    V = dia_stream.k1_geometry(XT.element_size())[2]
    base = (XT.data_ptr() // XT.element_size()) % V
    np.testing.assert_array_equal(
        Y.cpu().numpy(), emulate_k1(D, XT.cpu().numpy(), base))


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


K2_CASES = {
    "hub-50000": lambda: CsrMatrix(
        3, 50000, np.array([0, 0, 50000, 50000]), np.arange(50000),
        np.random.default_rng(9).standard_normal(50000)),
    "wheel-5000": CASES["wheel-5000"],
    "bibd_9_3": CASES["bibd_9_3"],
    "empty-rows": CASES["empty-rows"],
    "nnz-0": CASES["nnz-0"],
    "n-0": CASES["n-0"],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["K2", "K2d"])
@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_and_k2d_row_bounds_one_count_per_call(cuda, name, dtype):
    """K2 and K2d on a row spanning many tiles (hub-50000: 49 tiles),
    empty rows, nnz = 0 and num_rows = 0: one launch count a call, two
    runs bitwise equal, each row within (nnz_i + 2) u (|A||x|)_i of the
    float64 product (K2) or 2 (nnz_i + 2) u (|A||x|)_i of the plain
    version (K2d)."""
    M = merge_spmv.to_device_merge(K2_CASES[name](), cuda, dtype)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        M.num_cols)).to(cuda, dtype)
    label = "K2d" if dtype == torch.float64 else "K2"
    runs = 1 if M.num_rows + M.nnz else 0
    before = _build.LAUNCHES[label]
    y1 = merge_spmv.merge_matvec(M, x)
    assert _build.LAUNCHES[label] == before + runs
    y2 = merge_spmv.merge_matvec(M, x)
    assert _build.LAUNCHES[label] == before + 2 * runs
    assert y1.dtype == dtype and y1.shape == (M.num_rows,)
    assert torch.equal(y1, y2)
    args = (M.num_rows, M.row_offsets, M.col_indices)
    ax = csr_matvec(*args, M.values.abs().double(), x.abs().double())
    nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()
    if dtype == torch.float32:
        y64 = csr_matvec(*args, M.values.double(), x.double())
        assert torch.all((y1.double() - y64).abs() <= (nnz_i + 2) * U * ax)
    else:
        yp = merge_spmv.spmv_merge_plain(M, x)
        assert torch.all((y1 - yp).abs() <= 2 * (nnz_i + 2) * 2.0 ** -53
                         * ax)


def test_k2_refuses_a_plan_without_its_tiles(cuda, monkeypatch):
    """K2 needs the plan's tile starts, for its own tile: a plan without
    them, with the starts of another tile size or on another device
    raises, and so does a tile size that differs from the library's."""
    csr = gen.make_rmat(10).to_csr()
    M = merge_spmv.to_device_merge(csr, cuda)
    x = _x(M.num_cols, 3, cuda)
    merge_spmv.merge_matvec(M, x)
    other = merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz,
                                         2 * merge_spmv.TILE_ITEMS)
    for coords in (None, torch.from_numpy(other).to(cuda),
                   M.tile_coords.cpu(), M.tile_coords.long()):
        with pytest.raises(ValueError, match="tile_coords"):
            merge_spmv.merge_matvec(
                dataclasses.replace(M, tile_coords=coords), x)
    monkeypatch.setattr(merge_spmv, "TILE_ITEMS",
                        2 * merge_spmv.TILE_ITEMS)
    with pytest.raises(RuntimeError, match="tile"):
        merge_spmv.merge_matvec(M, x)


K3_LS = (1, 3, 16, 32, 33, 100, 136)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["K3", "K3d"])
@pytest.mark.parametrize("L", K3_LS)
@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_and_k3d_equal_their_emulation(cuda, name, L, dtype):
    """K3 and K3d on num_rows = 0, nnz = 0, empty rows, bibd_9_3, a wheel
    hub spanning several tiles and rmat-10 (L = 33 and 136 take two lane
    chunks, of one and of 16-byte lanes): one launch count a call, two
    runs bitwise equal, within 2 (nnz_i + 2) u (|A||X|)_i of the plain
    version, and equal bit for bit to the CPU emulation of K3's
    decomposition in the same type, on random values and on integer
    values (where every sum is exact)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    csr = K3_CASES[name]()
    rng = np.random.default_rng(L)
    rand_csr = CsrMatrix(csr.num_rows, csr.num_cols, csr.row_offsets,
                         csr.col_indices, rng.standard_normal(csr.nnz))
    X = rng.standard_normal((csr.num_cols, L)).astype(npdt)
    label = "K3d" if dtype == torch.float64 else "K3"
    runs = 1 if csr.num_rows + csr.nnz else 0
    for A, XA in ((rand_csr, X), integer_valued(csr, L, 3 + L)):
        M = merge_spmv.to_device_merge(A, cuda, dtype)
        Xd = torch.from_numpy(XA.astype(npdt)).to(cuda)
        before = _build.LAUNCHES[label]
        Y1 = spmm_merge.merge_matmat(M, Xd)
        assert _build.LAUNCHES[label] == before + runs
        Y2 = spmm_merge.merge_matmat(M, Xd)
        assert Y1.dtype == dtype and Y1.shape == (csr.num_rows, L)
        assert torch.equal(Y1, Y2)
        want = emulate_k3(A, XA.astype(npdt), M.tile_coords.cpu().numpy())
        np.testing.assert_array_equal(Y1.cpu().numpy(), want)
        args = (M.num_rows, M.row_offsets, M.col_indices)
        AX = csr_matmat(*args, M.values.abs().double(), Xd.abs().double())
        nnz_i = (M.row_offsets[1:] - M.row_offsets[:-1]).double()[:, None]
        u = U if dtype == torch.float32 else U64
        Yp = spmm_merge.spmm_merge_plain(M, Xd)
        assert torch.all((Y1.double() - Yp.double()).abs()
                         <= 2 * (nnz_i + 2) * u * AX)
    np.testing.assert_array_equal(Y1.cpu().numpy(), A.to_scipy() @ XA)


def test_k3_refuses_a_plan_without_its_tiles(cuda, monkeypatch):
    """K3 works on the plan's tile starts, K2's tiles: a plan without
    them, with the starts of another tile size or on another device
    raises, and so does a tile size that differs from the library's."""
    csr = gen.make_rmat(10).to_csr()
    M = merge_spmv.to_device_merge(csr, cuda)
    X = _x(None, 3, cuda, (M.num_cols, 16))
    spmm_merge.merge_matmat(M, X)
    other = merge_spmv.merge_tile_coords(csr.row_offsets, csr.nnz,
                                         2 * merge_spmv.TILE_ITEMS)
    for coords in (None, torch.from_numpy(other).to(cuda),
                   M.tile_coords.cpu(), M.tile_coords.long()):
        with pytest.raises(ValueError, match="tile_coords"):
            spmm_merge.merge_matmat(
                dataclasses.replace(M, tile_coords=coords), X)
    monkeypatch.setattr(merge_spmv, "TILE_ITEMS",
                        2 * merge_spmv.TILE_ITEMS)
    with pytest.raises(RuntimeError, match="tile"):
        spmm_merge.merge_matmat(M, X)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["K3", "K3d"])
def test_k3_takes_x_at_any_alignment(cuda, dtype):
    """K3 loads 16 bytes of X lanes at once: X starting one element past
    an aligned address gives the Y of an aligned copy, bit for bit."""
    M = merge_spmv.to_device_merge(gen.make_rmat(10).to_csr(), cuda, dtype)
    L = 16
    buf = torch.from_numpy(np.random.default_rng(4).standard_normal(
        M.num_cols * L + 1)).to(cuda, dtype)
    X = buf[1:].view(M.num_cols, L)
    assert X.is_contiguous() and X.data_ptr() % 16
    assert torch.equal(spmm_merge.merge_matmat(M, X),
                       spmm_merge.merge_matmat(M, X.clone()))


def test_cg_on_card_matches_cpu(cuda):
    csr = gen.make_laplacian_grid3d(12).to_csr()
    b = _x(csr.num_rows, 1, "cpu")
    r_cpu = cg_solve(plan_matrix(csr, "auto", device="cpu",
                                 dtype=np.float32), b)
    before = _build.LAUNCHES["K1"]
    r = cg_solve(plan_matrix(csr, "auto", device=cuda,
                             dtype=np.float32), b.to(cuda))
    assert _build.LAUNCHES["K1"] > before
    assert r.converged and abs(r.iterations - r_cpu.iterations) <= 1
    assert torch.linalg.norm(r.x.cpu() - r_cpu.x) \
        <= 1e-4 * torch.linalg.norm(r_cpu.x)


@pytest.mark.parametrize("max_iters", [500, 6])
def test_cg_lookahead_on_card_equals_the_eager_loop(cuda, tracer,
                                                    max_iters):
    """``cg_solve`` on K1d, reading each test one iteration late, gives
    the eager loop's answers bit for bit: the same kernels on the same
    data in the same order, the body issued ahead dropped. A solve that
    its test ends launches K1d once more than it iterates."""
    plan = plan_matrix(_hpcg27(8), device=cuda)          # float64: K1d
    b = _x64(3, cuda, (512,))
    before = _build.LAUNCHES["K1d"]
    eager = eager_cg(plan, b, max_iters, 1e-10, record_history=True)
    mid = _build.LAUNCHES["K1d"]
    trace.take()
    res = cg_solve(plan, b, max_iters, 1e-10, record_history=True)
    _, counters = trace.take()
    assert_same_solve(res, eager)
    assert res.converged == (max_iters == 500)
    ahead, discarded, _ = lookahead_counts(res, max_iters)
    assert sum(counters.get("cg.ahead", {}).values()) == ahead
    assert sum(counters.get("cg.discarded", {}).values()) == discarded
    assert mid - before == res.iterations > 0
    assert _build.LAUNCHES["K1d"] - mid == res.iterations + discarded

def test_no_fallback_on_cuda_tensors(cuda):
    csr = gen.make_laplacian_grid2d(4).to_csr()
    A = plan_matrix(csr, "auto", device=cuda, dtype=np.float32)
    # mixed types: float64 XT on a float32 operand
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_stream_t(A.dia, torch.zeros(1, 16, device=cuda,
                                                        dtype=torch.float64))
    M = plan_matrix(csr, "merge", device=cuda, dtype=np.float32)
    with pytest.raises(ValueError, match="same device"):
        merge_spmv.merge_matvec(M, torch.zeros(16))
    y = spmv(M, torch.ones(16, device=cuda))
    assert y.is_cuda


# (plan, kernel wrapper, plain version) of K3 and K4
SPMM_KERNELS = {
    "K3": (merge_spmv.to_device_merge, spmm_merge.merge_matmat,
           spmm_merge.spmm_merge_plain),
    "K4": (ell_spmm.to_device_row_split, ell_spmm.row_split_matmat,
           ell_spmm.spmm_row_split_plain),
}


@pytest.mark.parametrize("L", [1, 3, 16, 40])
@pytest.mark.parametrize("kernel", list(SPMM_KERNELS))
@pytest.mark.parametrize("name", list(CASES))
def test_spmm_kernels_match_plain_and_float64(cuda, name, kernel, L):
    plan, matmat, plain = SPMM_KERNELS[kernel]
    A = plan(CASES[name](), cuda)
    X = _x(None, 7, cuda, (A.num_cols, L))
    before = _build.LAUNCHES[kernel]
    Y1 = matmat(A, X)
    Y2 = matmat(A, X)
    assert _build.LAUNCHES[kernel] == before + (2 if A.num_rows else 0)
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
    P = plan_matrix(csr, "auto", L=8, device=cuda, dtype=np.float32)
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
    for strategy, label in (("auto", "K1"), ("merge", "K3"),
                            ("row_split", "K4")):
        r_cpu = cg_solve_multi(plan_matrix(csr, strategy, L=4, device="cpu",
                                           dtype=np.float32),
                               B)
        before = _build.LAUNCHES[label]
        r = cg_solve_multi(plan_matrix(csr, strategy, L=4, device=cuda,
                                       dtype=np.float32),
                           B.to(cuda))
        assert _build.LAUNCHES[label] > before
        assert bool(r.converged.all()) and bool(r_cpu.converged.all())
        assert abs(r.iterations - r_cpu.iterations) <= 1
        assert torch.all(torch.linalg.norm(r.x.cpu() - r_cpu.x, dim=0)
                         <= 1e-4 * torch.linalg.norm(r_cpu.x, dim=0))


def _long_row_csr():
    """Rows of 5, 10 C + 3, 0, C, C + 1 and 17 nonzeros (C the row-split
    chunk) at seeded random columns of 3000."""
    C = ell_spmm.ROW_CHUNK
    rng = np.random.default_rng(4)
    lengths = np.array([5, 10 * C + 3, 0, C, C + 1, 17])
    ro = np.zeros(lengths.shape[0] + 1, dtype=np.int32)
    np.cumsum(lengths, out=ro[1:])
    cols = np.concatenate([np.sort(rng.integers(0, 3000, n))
                           for n in lengths]).astype(np.int32)
    return CsrMatrix(lengths.shape[0], 3000, ro, cols,
                     rng.standard_normal(ro[-1]))


ROWSPLIT_CASES = {
    "long-row": _long_row_csr,
    "rmat-14": lambda: gen.make_rmat(14, 16).to_csr(),
}


def _k4_vs_cpu_plain(csr, dtype, L, dev):
    """K4 (or K4d) twice on the card against the plain version on a CPU
    copy of the plan and X: one launch a call, all three bitwise equal."""
    A = ell_spmm.to_device_row_split(csr, dev, dtype)
    Ac = ell_spmm.to_device_row_split(csr, "cpu", dtype)
    X = torch.from_numpy(np.random.default_rng(L).standard_normal(
        (csr.num_cols, L))).to(dtype)
    label = "K4d" if dtype == torch.float64 else "K4"
    before = _build.LAUNCHES[label]
    Y1 = ell_spmm.row_split_matmat(A, X.to(dev))
    assert _build.LAUNCHES[label] == before + (1 if A.num_rows else 0)
    Y2 = ell_spmm.row_split_matmat(A, X.to(dev))
    assert _build.LAUNCHES[label] == before + (2 if A.num_rows else 0)
    assert Y1.dtype == dtype and Y1.shape == (csr.num_rows, L)
    assert torch.equal(Y1, Y2)
    assert torch.equal(Y1.cpu(), ell_spmm.row_split_matmat(Ac, X))
    return A


@pytest.mark.parametrize("L", [1, 3, 16, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["K4", "K4d"])
@pytest.mark.parametrize("name", list(ROWSPLIT_CASES))
def test_k4_split_rows_match_cpu_plain_bitwise(cuda, name, dtype, L):
    A = _k4_vs_cpu_plain(ROWSPLIT_CASES[name](), dtype, L, cuda)
    assert A.table.num_chunks > 0


@pytest.mark.parametrize("L", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["K4", "K4d"])
@pytest.mark.parametrize("name", list(CASES))
def test_k4_cases_match_cpu_plain_bitwise(cuda, name, dtype, L):
    """The small fixtures: a split wheel hub, empty rows, nnz = 0 and
    num_rows = 0."""
    _k4_vs_cpu_plain(CASES[name](), dtype, L, cuda)


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
    before = _build.LAUNCHES["K5"]
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    assert _build.LAUNCHES["K5"] == before + 1
    assert Y.shape == (L, D.num_rows) and Y.device == XT.device
    assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))
    absD = dataclasses.replace(D, data=D.data.abs())
    AX = dia_stream.spmm_dia_planes_plain(absD, XT.abs().double())
    exact = dia_stream.spmm_dia_planes_plain(D, XT.double())
    assert torch.all((Y.double() - exact).abs()
                     <= len(D.offsets) * U * AX * 1.01)


def test_k5_empty_operands_launch_nothing(cuda):
    D = _planes(PLANE_CASES["var-7-12"](), cuda)
    before = _build.LAUNCHES["K5"]
    Y = dia_stream.spmm_dia_planes_t(
        D, torch.zeros(0, D.num_cols, device=cuda))
    assert Y.shape == (0, D.num_rows)
    E = DiaDevice(0, 5, (0, 2), torch.zeros(2, 0, device=cuda))
    assert dia_stream.spmm_dia_planes_t(
        E, torch.ones(3, 5, device=cuda)).shape == (3, 0)
    Z = DiaDevice(4, 4, (), torch.zeros(0, 4, device=cuda))
    assert torch.equal(dia_stream.spmm_dia_planes_t(
        Z, torch.ones(2, 4, device=cuda)), torch.zeros(2, 4, device=cuda))
    assert _build.LAUNCHES["K5"] == before


def test_k5_no_fallback_on_cuda_tensors(cuda):
    D = _planes(PLANE_CASES["var-7-12"](), cuda)
    n = D.num_rows
    # mixed types: float64 XT on float32 planes
    with pytest.raises(TypeError):
        dia_stream.spmm_dia_planes_t(
            D, torch.zeros(1, n, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="same device"):
        dia_stream.spmm_dia_planes_t(D, torch.zeros(1, n))
    before = _build.LAUNCHES["K5"]
    y = spmv(plan_matrix(gen.make_variable_stencil(12).to_csr(), "auto",
                         device=cuda,
                         dtype=np.float32), torch.ones(n, device=cuda))
    assert y.is_cuda and _build.LAUNCHES["K5"] == before + 1


def test_k5_equals_k1_on_constant_band(cuda):
    csr = gen.make_laplacian_grid3d(16).to_csr()
    D1 = plan_matrix(csr, "auto", device=cuda, dtype=np.float32).dia
    D5 = _planes(csr, cuda)
    XT = _x(None, 4, cuda, (4, csr.num_cols))
    assert torch.equal(dia_stream.spmm_dia_stream_t(D1, XT),
                       dia_stream.spmm_dia_planes_t(D5, XT))


def test_variable_band_solvers_on_card_match_cpu(cuda):
    csr = gen.make_variable_stencil(8, full=True, seed=2,
                                    shift=1.0).to_csr()
    b = _x(csr.num_rows, 4, "cpu")
    B = _x(None, 5, "cpu", (csr.num_rows, 4))
    plans = {dev: (plan_matrix(csr, "auto", device=dev, dtype=np.float32),
                   plan_dia_bf16(csr, device=dev)) for dev in ("cpu", cuda)}
    before = _build.LAUNCHES["K5"]
    runs = {dev: (cg_solve(A32, b.to(dev)), cg_solve_multi(A32, B.to(dev)),
                  cg_solve_bf16(A16, A32, b.to(dev)),
                  cg_solve_multi_refined_f32(A16, A32, B.to(dev)))
            for dev, (A32, A16) in plans.items()}
    assert _build.LAUNCHES["K5"] > before
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
    plan, matmat, _ = SPMM_KERNELS[kernel]
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
    before, before32 = _build.LAUNCHES["K1d"], _build.LAUNCHES["K1"]
    Y = dia_stream.spmm_dia_stream_t(D, XT)
    assert _build.LAUNCHES["K1d"] == before + 1
    assert _build.LAUNCHES["K1"] == before32
    assert Y.dtype == torch.float64 and Y.shape == (L, csr.num_cols)
    assert torch.equal(Y, dia_stream.spmm_dia_masked_plain(D, XT))
    assert torch.equal(Y, dia_stream.spmm_dia_stream_t(D, XT))


@pytest.mark.parametrize("L", [1, 4, 16])
@pytest.mark.parametrize("name", list(PLANE_CASES))
def test_k5d_matches_plain_bitwise(cuda, name, L):
    D = _planes(PLANE_CASES[name](), cuda, torch.float64)
    XT = _x64(L, cuda, (L, D.num_cols))
    before = _build.LAUNCHES["K5d"]
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    assert _build.LAUNCHES["K5d"] == before + 1
    assert Y.dtype == torch.float64 and Y.shape == (L, D.num_rows)
    assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))
    assert torch.equal(Y, dia_stream.spmm_dia_planes_t(D, XT))


@pytest.mark.parametrize("L", [1, 16])
def test_k5d_on_bp3_planes_counts_its_bytes(cuda, tracer, L):
    """K5d on CEED BP3's 27 value planes (``benchmark/matrices/bp3q1.py``
    at 12 elements a side) equals its plain version bit for bit, and
    counts one product and the bytes of its planes, X and Y."""
    import importlib.util

    path = ROOT / "benchmark/matrices/bp3q1.py"
    spec = importlib.util.spec_from_file_location("bench_bp3q1", path)
    bp3q1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bp3q1)
    cfg = {"dtype": "float64", "elements": 12, "order": 1, "quad_points": 3,
           "perturb": 0.2, "mesh_seed": 1}
    p = bp3q1.generate(cfg, None, cuda)
    plan = plan_matrix(CsrMatrix(p["num_rows"], p["num_cols"],
                                 p["row_offsets"], p["col_indices"],
                                 p["values"]), device=cuda)
    D = plan.dia
    assert isinstance(D, DiaDevice) and plan.rest is None
    n, K = D.num_rows, len(D.offsets)
    assert K == 27
    XT = _x64(L + 2, cuda, (L, n))
    tracer.take()
    Y = dia_stream.spmm_dia_planes_t(D, XT)
    _, counters = tracer.take()
    torch.cuda.synchronize()
    assert sum(counters["dia.planes_calls"].values()) == 1
    assert sum(counters["dia.planes_bytes"].values()) == (K + 2 * L) * n * 8
    assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))


@pytest.mark.parametrize("L", [1, 16])
def test_k5d_at_64_planes(cuda, L):
    """64 float64 planes, K5's limit (the design before the row runs
    staged them in a 64 KiB shared-memory tile)."""
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
    plan, matmat, plain = SPMM_KERNELS[kernel]
    csr = CASES[name]()
    A = plan(csr, cuda, torch.float64)
    X = _x64(11, cuda, (A.num_cols, L))
    before = _build.LAUNCHES[kernel + "d"]
    Y1, Y2 = matmat(A, X), matmat(A, X)
    assert _build.LAUNCHES[kernel + "d"] == before + (2 if A.num_rows else 0)
    assert Y1.dtype == torch.float64 and torch.equal(Y1, Y2)
    args = (A.num_rows, A.row_offsets, A.col_indices)
    AX = csr_matmat(*args, A.values.abs(), X.abs())
    nnz_i = (A.row_offsets[1:] - A.row_offsets[:-1]).double()[:, None]
    assert torch.all((Y1 - plain(A, X)).abs()
                     <= 2 * (nnz_i + 2) * U64 * AX)
    if kernel == "K3" and L == 1:
        M = merge_spmv.to_device_merge(csr, cuda, torch.float64)
        before = _build.LAUNCHES["K2d"]
        y1, y2 = merge_spmv.merge_matvec(M, X[:, 0]), \
            merge_spmv.merge_matvec(M, X[:, 0])
        assert _build.LAUNCHES["K2d"] == before + (2 if M.num_rows else 0)
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
        for kernel, (plan, matmat, _) in SPMM_KERNELS.items():
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
        A32 = plan_matrix(csr, "auto", device=dev, dtype=np.float32)
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


# --- K6 (permutation), the IC(0) host library, PCG and SPAI-CG ----------

K6_DTYPES = [torch.float32, torch.float64, torch.int32]


def _perm_x(n, L, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    shape = (n,) if L == 0 else (n, L)
    x = torch.from_numpy(rng.standard_normal(shape) * 1e3)
    return x.to(dtype).to(dev)


@pytest.mark.parametrize("n", [0, 1, 1023, 5000])
@pytest.mark.parametrize("L", [0, 1, 2, 3, 4, 16, 33, 1030])
@pytest.mark.parametrize("dtype", K6_DTYPES, ids=str)
def test_k6_matches_index_select_bitwise(cuda, dtype, L, n):
    """L = 0 is a vector (n,); every (n, L) block in every type (a row of
    1030 values has more words than a CTA has threads), with a random, a
    reversed and the identity permutation: bitwise equal to
    ``index_select`` and to its emulation, and through a ReorderedPlan
    (``apply_perm``, ``apply_inv``) there and back."""
    from tpusparse_torch.kernels import permute

    x = _perm_x(n, L, dtype, cuda, n + L)
    for perm in (np.random.default_rng(n).permutation(n),
                 np.arange(n)[::-1].copy(), np.arange(n)):
        p = permute.build_permute_plan(perm, cuda)
        before = _build.LAUNCHES["K6"]
        y = permute.permute_apply(p, x)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["K6"] == before + (1 if x.numel() else 0)
        assert y.dtype == x.dtype and y.shape == x.shape
        assert torch.equal(y, x.index_select(0, p))
        if n:
            np.testing.assert_array_equal(y.cpu().numpy(),
                                          emulate_k6(perm, x.cpu()).numpy())
        inv = permute.build_permute_plan(np.argsort(perm), cuda)
        A = ReorderedPlan(n, n, 0, None, p, inv)
        assert torch.equal(A.apply_perm(x), y)
        assert torch.equal(A.apply_inv(y), x)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k6_unaligned_rows(cuda, offset):
    """Rows of 16 B at an address that is only 4- (or 8-) aligned: K6
    falls back to narrower words and stays exact, as its emulation does."""
    from tpusparse_torch.kernels import permute

    n = 1000
    flat = torch.arange((n + 1) * 4, dtype=torch.float32, device=cuda)
    x = flat[offset:offset + n * 4].view(n, 4)
    perm = np.random.default_rng(1).permutation(n)
    p = permute.build_permute_plan(perm, cuda)
    y = permute.permute_apply(p, x)
    assert torch.equal(y, x.index_select(0, p))
    cpu = flat.cpu()
    np.testing.assert_array_equal(
        y.cpu().numpy(),
        emulate_k6(perm, cpu[offset:offset + n * 4].view(n, 4)).numpy())


def test_k6_raises_on_wrong_operands(cuda):
    from tpusparse_torch.kernels import permute

    perm = np.random.default_rng(2).permutation(100)
    with pytest.raises(ValueError, match="same device"):
        permute.permute_apply(permute.build_permute_plan(perm, "cpu"),
                              torch.zeros(100, device=cuda))
    bad = perm.copy()
    bad[5] = 100
    with pytest.raises(ValueError, match=r"\[0, 100\)"):
        permute.build_permute_plan(bad, cuda)
    p = permute.build_permute_plan(perm, cuda)
    with pytest.raises(ValueError, match="rows but the plan"):
        permute.permute_apply(p, torch.zeros(99, device=cuda))
    with pytest.raises(TypeError):
        permute.permute_apply(p, torch.zeros(100, device=cuda,
                                             dtype=torch.float16))


IC0_CASES = {
    "lap2d-24": lambda: gen.make_laplacian_grid2d(24).to_csr(),
    "lap3d-10": lambda: gen.make_laplacian_grid3d(10).to_csr(),
    "gr_30_30": lambda: read_market(ROOT / "data/real/gr_30_30.mtx"
                                    ).to_csr(),
    "fem2d-2000": lambda: gen.make_fem2d(2000, seed=1).to_csr(),
    "indefinite-2": lambda: CsrMatrix(2, 2, np.array([0, 2, 4]),
                                      np.array([0, 1, 0, 1]),
                                      np.array([1.0, 2.0, 2.0, 1.0])),
}


@pytest.mark.parametrize("name", list(IC0_CASES))
def test_native_ic0_and_levels_equal_python(cuda, name):
    from tpusparse_torch.precond import ic0, trisolve

    assert ic0.default_impl() == "native"
    csr = IC0_CASES[name]()
    Ln = ic0.ic0_factorize(csr, impl="native")
    Lp = ic0.ic0_factorize(csr, impl="python")
    np.testing.assert_array_equal(Ln.col_indices, Lp.col_indices)
    assert np.all(np.abs(Ln.values - Lp.values)
                  <= 1e-13 * np.abs(Lp.values))
    for T, lower in ((Lp, True), (Lp.transpose(), False)):
        ro, ci = np.asarray(T.row_offsets), np.asarray(T.col_indices)
        np.testing.assert_array_equal(
            trisolve._dependency_levels(ro, ci, T.num_rows, lower, "native"),
            trisolve._dependency_levels(ro, ci, T.num_rows, lower, "python"))
    with pytest.raises(RuntimeError):
        ic0.ic0_factorize(IC0_CASES["indefinite-2"](), max_attempts=1,
                          impl="native")


def test_preconditioned_solvers_on_card_match_cpu(cuda):
    from tpusparse_torch import (
        ic0_factorize,
        make_exact_ic0_preconditioner,
        make_ic0_preconditioner,
        pcg_solve_multi,
        spai_cg_solve_multi,
        spai_inverse,
    )
    from tpusparse_torch.kernels import permute
    from tpusparse_torch.ops.reorder import permute_symmetric

    lap = gen.make_laplacian_grid2d(32).to_csr()
    csr = permute_symmetric(
        lap, np.random.default_rng(5).permutation(lap.num_rows))
    Lf = ic0_factorize(csr)
    B = _x(None, 9, "cpu", (csr.num_rows, 4))
    M = spai_inverse(csr, device=cuda)
    M_cpu = spai_inverse(csr, device="cpu")
    assert np.abs(M.values - M_cpu.values).max() \
        <= 1e-10 * np.abs(M_cpu.values).max()
    out = {}
    for dev in ("cpu", cuda):
        A = plan_matrix(csr, "auto", reorder="rcm", L=4, device=dev,
                        dtype=np.float32)
        A0 = plan_matrix(csr, "auto", L=4, device=dev, dtype=np.float32)
        before = _build.LAUNCHES["K6"]
        out[dev] = (
            pcg_solve_multi(A0, B.to(dev), make_ic0_preconditioner(
                Lf, num_rhs=4, dtype=np.float32, device=dev)),
            pcg_solve_multi(A0, B.to(dev), make_exact_ic0_preconditioner(
                Lf, device=dev)),
            spai_cg_solve_multi(A0, plan_matrix(M, "auto", L=4, device=dev,
                                                dtype=np.float32),
                                B.to(dev)),
            cg_solve_multi(A, B.to(dev)),
            # in the permuted space, with the reordered matrix's factor,
            # declared in the plan's order
            pcg_solve_multi(A, B.to(dev), make_ic0_preconditioner(
                ic0_factorize(A.permuted(csr)), num_rhs=4, dtype=np.float32,
                device=dev, perm=A.perm)))
        if dev == cuda:
            assert _build.LAUNCHES["K6"] == before + 4
            # the caller's order, behind K6: two more launches an iteration
            before = _build.LAUNCHES["K6"]
            res = pcg_solve_multi(A, B.to(dev), make_ic0_preconditioner(
                Lf, num_rhs=4, dtype=np.float32, device=dev))
            assert _build.LAUNCHES["K6"] == \
                before + 2 + 2 * (res.iterations + 1)
            assert abs(res.iterations - out[dev][0].iterations) <= 1
    for g, c in zip(out[cuda], out["cpu"]):
        assert bool(g.converged.all()) and g.x.is_cuda
        assert abs(g.iterations - c.iterations) <= 1
        assert torch.linalg.norm(g.x.cpu() - c.x) \
            <= 1e-3 * torch.linalg.norm(c.x)


# --- K7 (n-major masked DIA), K8 and K8d (BSR panels) ----------------------

NMAJOR_CASES = {
    "lap3d-16": lambda: gen.make_laplacian_grid3d(16).to_csr(),
    "lap2d-33": lambda: gen.make_laplacian_grid2d(33).to_csr(),  # 1089 rows
    # 125 rows: fewer than one CTA's block at every L
    "lap3d-5": lambda: gen.make_laplacian_grid3d(5).to_csr(),
}


@pytest.mark.parametrize("L", [2, 3, 4, 5, 16, 33, 100, 128])
@pytest.mark.parametrize("name", list(NMAJOR_CASES))
def test_k7_matches_plain_and_k1_bitwise(cuda, name, L):
    """Every lane group (V = 2, 1, 4, 1, 4, 1, 4, 4), and V = 1 and 2 on an
    X whose data starts 4 or 8 bytes off a 16-byte boundary: bitwise
    equal to the plain version, to the emulation and to K1 on X.T."""
    from tpusparse_torch.kernels import dia_nmajor

    A = plan_matrix(NMAJOR_CASES[name](), "nmajor", L=L, device=cuda,
                    dtype=np.float32)
    D = A.dia
    X = _x(None, L, cuda, (D.num_cols, L))
    before = _build.LAUNCHES["K7"]
    Y1 = dia_nmajor.nmajor_matmat(D.band, X)
    Y2 = dia_nmajor.nmajor_matmat(D.band, X)
    assert _build.LAUNCHES["K7"] == before + 2
    assert Y1.shape == (D.num_rows, L) and torch.equal(Y1, Y2)
    assert torch.equal(Y1, dia_nmajor.spmm_nmajor_plain(D.band, X))
    V = dia_nmajor.k7_lane_group(L, X, Y1)
    np.testing.assert_array_equal(Y1.cpu().numpy(),
                                  emulate_k7(D, X.cpu().numpy(), V))
    YT = dia_stream.spmm_dia_stream_t(D.band, X.T.contiguous())
    assert torch.equal(Y1, YT.T)
    # through spmm / spmv on the plan, fewer columns than its L
    assert torch.equal(spmm(A, X[:, :1].contiguous())[:, 0],
                       spmv(A, X[:, 0].contiguous()))
    for shift in (1, 2):
        flat = torch.empty(X.numel() + shift, device=cuda)
        Xs = flat[shift:].view(X.shape)
        Xs.copy_(X)
        assert torch.equal(dia_nmajor.nmajor_matmat(D.band, Xs), Y1)


@pytest.mark.parametrize("L", [2, 3, 16, 128])
def test_spmm_on_a_masked_band_runs_k7_on_row_major_x(cuda, L):
    """``spmm`` on AUTO's masked band with a row-major float32 X launches
    K7 once and K1 not at all, and equals K1 on X.T bit for bit."""
    from tpusparse_torch.kernels import dia_nmajor

    A = plan_matrix(NMAJOR_CASES["lap3d-16"](), "auto", device=cuda,
                    dtype=np.float32)
    assert plan_kind(A) == "dia"
    X = _x(None, 80 + L, cuda, (A.dia.num_cols, L))
    k7, k1 = _build.LAUNCHES["K7"], _build.LAUNCHES["K1"]
    Y = spmm(A, X)
    assert _build.LAUNCHES["K7"] == k7 + 1 and _build.LAUNCHES["K1"] == k1
    assert Y.shape == X.shape and Y.is_contiguous()
    YT = dia_stream.spmm_dia_stream_t(A.dia, X.T.contiguous())
    assert torch.equal(Y, YT.T)


def test_k7_refuses_wrong_operands(cuda):
    from tpusparse_torch.kernels import dia_nmajor

    A = plan_matrix(NMAJOR_CASES["lap2d-33"](), "nmajor", L=4, device=cuda,
                    dtype=np.float32)
    n = A.dia.num_rows
    with pytest.raises(ValueError, match="L <= 4"):
        spmm(A, torch.zeros(n, 5, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        dia_nmajor.nmajor_matmat(A.dia.band, torch.zeros(
            n, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="same device"):
        dia_nmajor.nmajor_matmat(A.dia.band, torch.zeros(n, 2))
    with pytest.raises(ValueError, match="contiguous"):
        dia_nmajor.nmajor_matmat(A.dia.band,
                                 torch.zeros(2, n, device=cuda).T)
    with pytest.raises(ValueError):
        plan_matrix(NMAJOR_CASES["lap2d-33"](), "nmajor", L=1, device=cuda,
                    dtype=np.float32)


def test_new_kernels_do_not_fall_back_without_the_library(cuda,
                                                          monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no library to
    load, K7, K8, K8d and K6 (alone and through a ReorderedPlan) raise
    instead of running their plain versions."""
    from tpusparse_torch.kernels import bsr, dia_nmajor, permute

    A = plan_matrix(NMAJOR_CASES["lap2d-33"](), "nmajor", L=4, device=cuda,
                    dtype=np.float32)
    Bf = plan_matrix(gen.make_block_random(4, 2).to_csr(), "bsr",
                     device=cuda, dtype=np.float32)
    Bd = plan_matrix(gen.make_block_random(4, 2).to_csr(), "bsr",
                     dtype=np.float64, device=cuda)

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", missing)
    with pytest.raises(RuntimeError, match="nvcc"):
        dia_nmajor.nmajor_matmat(A.dia.band, torch.zeros(A.dia.num_rows, 2,
                                                         device=cuda))
    for P, dt in ((Bf, torch.float32), (Bd, torch.float64)):
        with pytest.raises(RuntimeError, match="nvcc"):
            bsr.bsr_matmat(P, torch.zeros(P.num_cols, 3, device=cuda,
                                          dtype=dt))
    perm = np.random.default_rng(8).permutation(64)
    p = permute.build_permute_plan(perm, cuda)
    R = ReorderedPlan(64, 64, 0, None, p,
                      permute.build_permute_plan(np.argsort(perm), cuda))
    for x in (torch.zeros(64, device=cuda), torch.zeros(64, 16, device=cuda)):
        for fn in (lambda: permute.permute_apply(p, x),
                   lambda: R.apply_perm(x), lambda: R.apply_inv(x)):
            with pytest.raises(RuntimeError, match="nvcc"):
                fn()


def _bsr_cases():
    """name -> host CSR of K8's checks: full (8, 128) blocks, partial
    fill, a cut edge with an emptied block row, and nnz = 0."""
    def edge():
        S = gen.make_block_random(20, 3, seed=4).to_csr().to_scipy()
        S = S[:155, :2500].tolil()
        S[16:24, :] = 0
        return CsrMatrix.from_scipy(S)

    return {
        "block-16x4": lambda: gen.make_block_random(16, 4).to_csr(),
        "block-12x3-fill0.3": lambda: gen.make_block_random(
            12, 3, fill=0.3, seed=2).to_csr(),
        "edge-155x2500": edge,
        "nnz-0": lambda: CsrMatrix(24, 300, np.zeros(25, np.int32),
                                   np.zeros(0, np.int32), np.zeros(0)),
    }


BSR_CASES = _bsr_cases()


def _check_k8(A, X):
    """K8 (K8d) on the BCSR operand ``A``: two runs bitwise equal, within
    2(w_i + 2)u|A||X| of its plain version and of float64."""
    from tpusparse_torch.kernels import bsr

    tdt, L = X.dtype, X.shape[1]
    dtype = np.float32 if tdt == torch.float32 else np.float64
    label = "K8" if dtype == np.float32 else "K8d"
    before = _build.LAUNCHES[label]
    Y1 = bsr.bsr_matmat(A, X)
    Y2 = bsr.bsr_matmat(A, X)
    assert _build.LAUNCHES[label] == before + 2
    assert Y1.shape == (A.num_rows, L) and Y1.dtype == tdt
    assert torch.equal(Y1, Y2)
    Yp = bsr.bsr_spmm_plain(A, X)
    A64 = dataclasses.replace(A, blocks=A.blocks.double())
    Y64 = bsr.bsr_spmm_plain(A64, X.double())
    AX = bsr.bsr_spmm_plain(dataclasses.replace(A64, blocks=A64.blocks.abs()),
                            X.double().abs())
    per = (A.block_row_offsets[1:] - A.block_row_offsets[:-1]).double()
    w = (per * A.block_cols).repeat_interleave(A.block_rows)[:A.num_rows]
    u = U if dtype == np.float32 else 2.0 ** -53
    bound = 2 * (w[:, None] + 2) * u * AX
    assert torch.all((Y1.double() - Yp.double()).abs() <= bound)
    assert torch.all((Y1.double() - Y64).abs() <= bound)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L", [1, 3, 16, 32])
@pytest.mark.parametrize("name", list(BSR_CASES))
def test_k8_matches_plain_and_float64(cuda, name, L, dtype):
    A = plan_matrix(BSR_CASES[name](), "bsr", dtype=dtype, device=cuda)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    _check_k8(A, _x(None, 11, cuda, (A.num_cols, L)).to(tdt))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("blocks,L", [((8, 1024), 32), ((4, 8), 300),
                                      ((3, 5), 7), ((40, 16), 9)])
def test_k8_other_blocks_and_wide_panels(cuda, blocks, L, dtype):
    """Blocks other than (8, 128) and wide X: block columns copied in
    chunks ((8, 1024) at L = 32), a panel wider than the CTA's 256
    threads (L = 300), odd shapes, and more block rows than one round
    covers ((40, 16) at L = 9)."""
    from tpusparse_torch.formats.bcsr import BcsrMatrix

    S = sp.random(203, 3100, density=0.01, format="csr",
                  random_state=np.random.default_rng(3))
    A = BcsrMatrix.from_csr(CsrMatrix.from_scipy(S), *blocks).to(cuda,
                                                                  dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    _check_k8(A, _x(None, 12, cuda, (A.num_cols, L)).to(tdt))


def _k5_operands(name, plane_dtype, L, dev, shift=0):
    """(D on dev, XT on dev): XT is a contiguous view ``shift`` elements
    into a fresh buffer."""
    D = K5_CASES[name](plane_dtype)
    D = dataclasses.replace(D, data=D.data.to(dev))
    dtype = torch.float64 if plane_dtype == torch.float64 else torch.float32
    x = np.random.default_rng(50 + L).standard_normal((L, D.num_cols))
    buf = torch.zeros(L * D.num_cols + shift, dtype=dtype, device=dev)
    XT = buf[shift:].view(L, D.num_cols)
    XT.copy_(torch.from_numpy(x))
    return D, XT


@pytest.mark.parametrize("L", [1, 3, 16, 33])
@pytest.mark.parametrize("plane_dtype", [torch.float32, torch.bfloat16,
                                         torch.float64],
                         ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("name", list(K5_CASES))
def test_k5_and_k5d_equal_their_emulation(cuda, name, plane_dtype, L):
    """K5 (K5d with float64 planes) equals ``emulate_k5`` and its plain
    version bit for bit on var-7, var-27, rectangular bands, offsets
    past n, K = 0, K = 64 (no plane tile at L > 1 past 227 KiB) and n
    below a row block, on XT aligned to 16 bytes and one element off;
    one launch a call (none at K = 0)."""
    f64 = plane_dtype == torch.float64
    counter = "K5d" if f64 else "K5"
    for shift in (0, 1):
        D, XT = _k5_operands(name, plane_dtype, L, cuda, shift)
        before = _build.LAUNCHES[counter]
        Y = dia_stream.spmm_dia_planes_t(D, XT)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[counter] == before + (
            len(D.offsets) > 0)
        assert Y.dtype == XT.dtype and Y.shape == (L, D.num_rows)
        assert torch.equal(Y, dia_stream.spmm_dia_planes_plain(D, XT))
        np.testing.assert_array_equal(
            Y.cpu().numpy(),
            emulate_k5(dataclasses.replace(D, data=D.data.cpu()),
                       XT.cpu().numpy()))


REFERENCE_CASES = {**CASES,
                   "Trefethen_200": PLANE_CASES["Trefethen_200"],
                   "lap3d-24": lambda: gen.make_laplacian_grid3d(
                       24).to_csr()}


@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(REFERENCE_CASES))
def test_reference_product_repeats_the_cpu_bits(cuda, name, dtype, L):
    """The reference product (KR, KRd in float64) adds each row in CSR
    order: two calls on the card give equal bits, and they are the CPU
    plain version's; through ``strategy='reference'`` too."""
    csr = REFERENCE_CASES[name]()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    C = plan_matrix(csr, "reference", dtype=np_dtype, device=cuda)
    Ch = plan_matrix(csr, "reference", dtype=np_dtype, device="cpu")
    X = torch.from_numpy(np.random.default_rng(60 + L).standard_normal(
        (csr.num_cols, L))).to(dtype)
    args = (C.num_rows, C.row_offsets, C.col_indices, C.values)
    hargs = (Ch.num_rows, Ch.row_offsets, Ch.col_indices, Ch.values)
    counter = "KRd" if dtype == torch.float64 else "KR"
    before = _build.LAUNCHES[counter]
    Y1 = csr_matmat(*args, X.to(cuda))
    Y2 = spmm(C, X.to(cuda))
    y1 = csr_matvec(*args, X[:, 0].to(cuda))
    y2 = spmv(C, X[:, 0].to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 4 * (
        csr.num_rows > 0)
    want = csr_matmat(*hargs, X)
    assert torch.equal(Y1.cpu(), want) and torch.equal(Y2.cpu(), want)
    want1 = csr_matvec(*hargs, X[:, 0])
    assert torch.equal(y1.cpu(), want1) and torch.equal(y2.cpu(), want1)


def test_reference_product_does_not_fall_back(cuda, monkeypatch):
    """A CUDA tensor launches KR or raises: with no library to load the
    reference product raises, and a value type KR does not take raises
    TypeError."""
    C = plan_matrix(CASES["wheel-5000"](), "reference", dtype=np.float32,
                    device=cuda)
    args = (C.num_rows, C.row_offsets, C.col_indices)
    with pytest.raises(TypeError):
        csr_matvec(*args, C.values.half(), torch.ones(C.num_cols,
                                                      device=cuda))

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", missing)
    with pytest.raises(RuntimeError, match="nvcc"):
        spmv(C, torch.ones(C.num_cols, device=cuda))
