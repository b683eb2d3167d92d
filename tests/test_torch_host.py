"""Port host layer against the JAX package: generators, .mtx reader,
DIA partition, comparison utilities, models, plan validation, and the
port's independence from JAX.

Inputs come from numpy seeds and are handed to both packages; host
arrays must agree exactly."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse.bench import models as jmodels
from tpusparse.formats import dia as jdia
from tpusparse.io import generators as jgen
from tpusparse.io.market import read_market as jread_market
from tpusparse.utils import compare as jcompare
from tpusparse_torch import (
    CsrMatrix,
    plan_kind,
    plan_matrix,
    plan_semantics,
    spmv,
)
from tpusparse_torch.bench import models
from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
from tpusparse_torch.formats import dia
from tpusparse_torch.io import generators as gen
from tpusparse_torch.io.market import read_market
from tpusparse_torch.ops.reference import spmv_numpy
from tpusparse_torch.utils import compare

ROOT = Path(__file__).resolve().parent.parent
REAL = sorted((ROOT / "data" / "real").glob("*.mtx"))

GENERATORS = [
    ("make_laplacian_grid2d", (16,), {}),
    ("make_laplacian_grid3d", (12,), {}),
    ("make_wheel", (300,), {}),
    ("make_rmat", (10,), {}),
    ("make_rmat", (8,), {"edge_factor": 4, "seed": 3, "symmetric": False}),
    ("make_rmat_spd", (10,), {}),
    ("make_variable_stencil", (6,), {}),
    ("make_variable_stencil", (5,), {"dims": 2, "full": True, "seed": 2}),
]


def _assert_csr_equal(a, b):
    assert a.shape == b.shape
    for name in ("row_offsets", "col_indices", "values"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{g[0]}{g[1]}{g[2] or ''}" for g in GENERATORS])
def test_generator_gives_jax_arrays(name, args, kw):
    port = getattr(gen, name)(*args, **kw)
    ref = getattr(jgen, name)(*args, **kw)
    assert port.shape == ref.shape
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        assert getattr(port, f).dtype == getattr(ref, f).dtype
    _assert_csr_equal(port.to_csr(), ref.to_csr())
    _assert_csr_equal(port.to_csr(sum_dups=True), ref.to_csr(sum_dups=True))


@pytest.mark.parametrize("path", REAL, ids=[p.stem for p in REAL])
def test_read_market_gives_jax_matrix(path):
    port = read_market(path).to_csr()
    ref = jread_market(path).to_csr()
    _assert_csr_equal(port, ref)


@pytest.mark.parametrize("fixture", ["lap3d", "varstencil", "wheel", "rmat",
                                     "bibd"])
def test_dia_partition_matches_jax(fixture):
    make = {
        "lap3d": lambda m: m.make_laplacian_grid3d(8),
        "varstencil": lambda m: m.make_variable_stencil(6),
        "wheel": lambda m: m.make_wheel(50),
        "rmat": lambda m: m.make_rmat(8),
    }
    if fixture == "bibd":
        port = read_market(ROOT / "data/real/bibd_9_3.mtx").to_csr()
        ref = jread_market(ROOT / "data/real/bibd_9_3.mtx").to_csr()
    else:
        port, ref = make[fixture](gen).to_csr(), make[fixture](jgen).to_csr()
    for a, b in zip(dia.diagonal_profile(port), jdia.diagonal_profile(ref)):
        np.testing.assert_array_equal(a, b)
    offs = dia.select_diagonals(port)
    np.testing.assert_array_equal(offs, jdia.select_diagonals(ref))
    dp, rest_p = dia.partition_dia(port, offs)
    dj, rest_j = jdia.partition_dia(ref, offs)
    np.testing.assert_array_equal(dp.offsets, dj.offsets)
    np.testing.assert_array_equal(dp.data, dj.data)
    _assert_csr_equal(rest_p, rest_j)
    for a, b in zip(dia.plane_constants(dp.data),
                    jdia.plane_constants(dj.data)):
        np.testing.assert_array_equal(a, b)


def test_compare_utils_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal(500).astype(np.float32)
    b = (a + rng.standard_normal(500) * 1e-6).astype(np.float32)
    b[::7] = -b[::7]
    np.testing.assert_array_equal(compare.ulp_distance(a, b),
                                  jcompare.ulp_distance(a, b))
    for x, y in ((a, b), (a, a), (a, a + np.float32(1e-3))):
        assert compare.compare_results(x, y) == jcompare.compare_results(x, y)
        assert compare.compare_results(torch.from_numpy(x), y) \
            == jcompare.compare_results(x, y)
    with pytest.raises(AssertionError, match="FAIL ctx"):
        compare.assert_close(a, -a, context="ctx")


def test_models_match_jax():
    assert models.spmv_flops(760320) == jmodels.spmv_flops(760320)
    assert models.spmv_flops(10, L=4) == jmodels.spmv_flops(10, L=4)
    assert models.spmv_bytes(760320, 110592) \
        == jmodels.spmv_bytes(760320, 110592)
    assert models.dia_masked_bytes(110592, L=4) \
        == jmodels.dia_masked_bytes(110592, L=4)
    assert models.gflops(2e9, 1.0) == jmodels.gflops(2e9, 1.0) == 2.0
    assert models.gflops(1.0, 0.0) == 0.0
    assert models.cg_flops(28518400, 4096000, 16, 70) \
        == jmodels.cg_flops(28518400, 4096000, 16, 70)


def test_dia_planes_bytes():
    # var-7-160: 7 f32 planes, x and y once; bf16 planes at 2 B, L = 16
    n = 4096000
    assert models.dia_planes_bytes(n, n, 7) == 7 * 4 * n + 2 * 4 * n
    assert models.dia_planes_bytes(n, n, 27, L=16, plane_bytes=2) \
        == 27 * 2 * n + 16 * 2 * 4 * n
    assert models.dia_planes_bytes(130, 135, 3, L=2) \
        == 3 * 4 * 130 + 2 * (130 + 135) * 4


def test_spmm_bytes_and_bound():
    # lap3d-160 at L = 16: payload 8 B per nonzero, offsets, X and Y
    nnz, n, L = 28518400, 4096000, 16
    b = models.spmm_bytes(nnz, n, n, L)
    assert b == 8 * nnz + 4 * (n + 1) + 2 * 4 * n * L
    ms, by = models.bound_ms(models.spmv_flops(nnz, L), b)
    assert by == "bytes" and ms == pytest.approx(b / 3.35e12 * 1e3)
    ms, by = models.bound_ms(67e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_csr_to_device_dtypes():
    csr = gen.make_laplacian_grid2d(6).to_csr()
    d = csr.to("cpu")
    assert d.row_offsets.dtype == torch.int32
    assert d.col_indices.dtype == torch.int32
    assert d.values.dtype == torch.float32
    np.testing.assert_array_equal(d.values.numpy(),
                                  csr.values.astype(np.float32))
    assert d.shape == csr.shape and d.nnz == csr.nnz


def test_csr_to_raises_past_int32_offsets():
    big = np.broadcast_to(np.int32(0), (2**31,))  # no memory behind it
    csr = CsrMatrix(1, 1, np.array([0, 2**31]), big, big)
    with pytest.raises(ValueError, match="int32"):
        csr.to("cpu")


def test_spmv_numpy_is_float64_golden():
    csr = gen.make_rmat(7).to_csr().astype(np.float32)
    x = np.random.default_rng(1).standard_normal(csr.num_cols).astype(
        np.float32)
    y = spmv_numpy(csr, x)
    assert y.dtype == np.float64
    np.testing.assert_allclose(
        y, csr.to_scipy().astype(np.float64) @ x.astype(np.float64),
        rtol=1e-12, atol=1e-12)
    yb = spmv_numpy(csr, x, alpha=2.0, beta=0.5, y=np.ones(csr.num_rows))
    np.testing.assert_allclose(yb, 2.0 * y + 0.5, rtol=1e-12)


def test_spmv_reference_alpha_beta():
    csr = gen.make_laplacian_grid2d(5).to_csr()
    d = csr.to("cpu")
    x = torch.linspace(-1, 1, csr.num_cols)
    y0 = torch.ones(csr.num_rows)
    y = spmv(d, x, alpha=2.0, beta=3.0, y=y0)
    ref = 2.0 * spmv_numpy(csr, x.numpy()) + 3.0
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-6, atol=1e-6)


# the JAX package's AUTO families: its dense diagonals carry >= 30 % of
# rmat-7's and of bibd_9_3's (36 x 84) nonzeros, so both peel them
PLAN_KINDS = [
    ("lap3d", lambda: gen.make_laplacian_grid3d(6), "dia"),
    ("wheel", lambda: gen.make_wheel(40), "hybrid_dia"),
    ("rmat", lambda: gen.make_rmat(7), "hybrid_dia"),
    ("varstencil", lambda: gen.make_variable_stencil(5), "dia"),
    ("bibd", lambda: read_market(ROOT / "data/real/bibd_9_3.mtx"),
     "hybrid_dia"),
]


@pytest.mark.parametrize("name,make,kind", PLAN_KINDS,
                         ids=[p[0] for p in PLAN_KINDS])
def test_auto_plan_kind(name, make, kind):
    csr = make().to_csr()
    A = plan_matrix(csr, "auto", device="cpu", dtype=np.float32)
    assert plan_kind(A) == kind
    assert plan_semantics(A) == "f32"
    assert plan_kind(plan_matrix(csr, "merge", device="cpu",
                                 dtype=np.float32)) == "merge"
    assert plan_kind(plan_matrix(csr, "reference", device="cpu",
                                 dtype=np.float32)) \
        == "reference"


# (case, plan_matrix arguments, plan family once its ROADMAP item is
# done; None while it still raises)
NOT_PORTED = [
    ("fp64", {"dtype": np.float64}, "dia"),
    ("torch-fp64", {"dtype": torch.float64}, "dia"),
    ("multi-rhs", {"L": 4}, "dia"),
    ("reorder", {"reorder": "rcm"}, "rcm+hybrid_dia"),
    ("row_split", {"strategy": "row_split", "L": 4}, "row_split"),
    ("ell-alias", {"strategy": "ell", "L": 4}, "row_split"),
    ("bsr", {"strategy": "bsr"}, "bsr"),
    ("bcoo", {"strategy": "bcoo"}, None),
    ("nmajor", {"strategy": "nmajor", "L": 4}, "dia_nmajor"),
    ("nonzero_split", {"strategy": "nonzero_split"}, None),
]


@pytest.mark.parametrize("name,kw,kind", NOT_PORTED,
                         ids=[n for n, _, _ in NOT_PORTED])
def test_plan_matrix_names_roadmap_item(name, kw, kind):
    """A plan the port does not build yet raises NotImplementedError
    naming its ROADMAP item; one whose item is done (A8: multi-RHS
    plans, ``row_split`` and its aliases; A9: float64 plans; A10:
    reordered plans; A15: n-major plans; A8b: BSR plans) plans its
    family."""
    csr = gen.make_laplacian_grid2d(6).to_csr()
    if kind is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plan_matrix(csr, device="cpu", **{"dtype": np.float32, **kw})
    else:
        kw = {"dtype": np.float32, **kw}
        assert plan_kind(plan_matrix(csr, device="cpu", **kw)) == kind


def test_nmajor_single_rhs_raises_as_in_jax():
    """'nmajor' is a multi-RHS plan: at L = 1 it raises ValueError, as the
    JAX package's does, instead of handing back another family."""
    csr = gen.make_laplacian_grid2d(6).to_csr()
    with pytest.raises(ValueError, match="L >= 2"):
        plan_matrix(csr, "nmajor", device="cpu", dtype=np.float32)


def test_explicit_dia_on_variable_band_names_b2():
    """Explicit 'dia' on a variable band plans the value-plane operand
    of K5, the port of B2; a constant band stays masked (K1)."""
    csr = gen.make_variable_stencil(5).to_csr()
    A = plan_matrix(csr, "dia", device="cpu", dtype=np.float32)
    assert plan_kind(A) == "dia" and isinstance(A.dia, dia.DiaDevice)
    assert A.rest is None and A.dia.data.dtype == torch.float32
    host, _ = dia.partition_dia(csr, dia.select_diagonals(csr))
    np.testing.assert_array_equal(A.dia.data.numpy(),
                                  host.data.astype(np.float32))
    lap = gen.make_laplacian_grid3d(5).to_csr()
    assert not isinstance(plan_matrix(lap, "dia", device="cpu",
                                      dtype=np.float32).dia,
                          dia.DiaDevice)


def test_timers_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for timer in (cuda_time_ms, graph_time_ms):
        with pytest.raises(RuntimeError, match="CUDA"):
            timer(lambda: None)


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpusparse)\b")
    files = sorted((ROOT / "tpusparse_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, tpusparse_torch, tpusparse_torch.utils.carry, "
            "tpusparse_torch.bench.timing, tpusparse_torch.bench.models, "
            "tpusparse_torch.ops.hybrid, tpusparse_torch.solvers.refine, "
            "tpusparse_torch.utils.trace; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpusparse')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
