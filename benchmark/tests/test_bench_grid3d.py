"""The ``--grid3d`` 7-point configuration and its cell: the generator's
counts and arrays, its stencil reference against a CSR product, the
harness finding the cell's files, and the two readers of the layout
change at ``spmm``'s DIA boundary on hand-made records."""

import json
import time
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import devtrace
import harness
import program_trace
from conftest import ROOT
from tpusparse_torch.utils import trace
from tpusparse_torch.utils.trace import Span

CELL = "grid3d-spmm16n"
CFG = json.loads((ROOT / "benchmark/configs/grid3d-7pt-160.json").read_text())
grid3d7 = harness.load_module(ROOT / "benchmark/matrices/grid3d7.py")
READERS = ["layout_bytes.product", "layout_ms.product"]
US = 1000  # ns


def _scipy(p):
    return sp.csr_matrix((p["values"], p["col_indices"], p["row_offsets"]),
                         shape=(p["num_rows"], p["num_cols"]))


def _laplacian_scipy(nx, ny, nz):
    """The 7-point Laplacian as a Kronecker sum, x fastest."""
    def path(m):
        return sp.diags([-1.0, -1.0], [-1, 1], shape=(m, m))

    def eye(m):
        return sp.identity(m)
    return (6.0 * sp.identity(nx * ny * nz)
            + sp.kron(sp.kron(eye(nz), eye(ny)), path(nx))
            + sp.kron(sp.kron(eye(nz), path(ny)), eye(nx))
            + sp.kron(sp.kron(path(nz), eye(ny)), eye(nx))).tocsr()


def test_grid3d_counts_in_config():
    nx, ny, nz = CFG["nx"], CFG["ny"], CFG["nz"]
    assert CFG["num_rows"] == nx * ny * nz == 4_096_000
    assert CFG["nnz"] == (7 * nx * ny * nz - 2 * (nx * ny + ny * nz
                                                  + nx * nz)) == 28_518_400
    p = grid3d7.generate(dict(CFG, nx=9, ny=8, nz=7), None, "cpu")
    assert p["num_rows"] == 9 * 8 * 7
    assert p["col_indices"].shape[0] == 7 * 504 - 2 * (72 + 56 + 63)


@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 4, 3)])
def test_grid3d_matches_scipy_construction(dims):
    p = grid3d7.generate(dict(CFG, nx=dims[0], ny=dims[1], nz=dims[2]),
                         None, "cpu")
    A = _scipy(p)
    assert p["values"].dtype == np.float32
    assert p["row_offsets"].dtype == np.int32
    assert (A != _laplacian_scipy(*dims)).nnz == 0
    counts = np.diff(p["row_offsets"])
    assert counts.max() == 7 and counts.min() == 4
    for r in range(A.shape[0]):
        cols = p["col_indices"][p["row_offsets"][r]:p["row_offsets"][r + 1]]
        assert np.all(np.diff(cols) > 0)


@pytest.mark.parametrize("L", [1, 3, 16])
def test_grid3d_stencil_is_the_matrix(L):
    cfg = dict(CFG, nx=6, ny=5, nz=4)
    p = grid3d7.generate(cfg, None, "cpu")
    A = _scipy(p).astype(np.float64)
    X = torch.randn((A.shape[0], L) if L > 1 else (A.shape[0],),
                    dtype=torch.float64)
    got = grid3d7.reference_matmat(cfg, p, X)
    assert got.shape == X.shape
    np.testing.assert_allclose(got.numpy(), A @ X.numpy(), rtol=1e-14,
                               atol=1e-12)
    got_abs = grid3d7.reference_matmat(cfg, p, X, absolute=True)
    np.testing.assert_allclose(got_abs.numpy(), abs(A) @ X.abs().numpy(),
                               rtol=1e-14, atol=1e-12)


def test_harness_finds_the_cells_files_and_readers():
    cell = harness.find_cell(ROOT, CELL, True)
    assert cell.cfg["generator"] == "grid3d7" and cell.dtype == torch.float32
    assert cell.kind == "product" and int(cell.mix["lanes"]) == 16
    assert cell.limits == {"rel_err": 1e-4}
    assert cell.matrix.__file__.endswith("matrices/grid3d7.py")
    assert set(READERS) <= set(cell.readers)
    assert {"plan_select_s", "plan_partition_s", "dispatch_self_us.product",
            "product_roofline.product"} <= set(cell.readers)
    e2e = harness.find_cell(ROOT, CELL, False)
    assert set(e2e.readers) == {"setup_s", "product_gflops"}


def test_traced_run_counts_one_copy_of_x_a_call(tiny_root):
    """On the CPU (the plain versions) the cell plans the masked band and
    each ``spmm`` call copies X (n, 16) to (16, n) once."""
    out = harness.run_cell(tiny_root, CELL, 2**31 + 11, 0.2, True, "cpu",
                           time.perf_counter(), {"import": 0.0})
    trace.disable()
    trace.take()
    assert out["correct"] is True, out["checks"]
    n = 7 * 5 * 4                     # the tiny grid of benchmark/conftest.py
    assert out["metrics"]["layout_bytes.product"] == {
        "value": 2 * n * 16 * 4 / 1e6, "unit": "MB"}
    assert "layout_ms.product" not in out["metrics"]  # no device trace


@pytest.fixture
def readers():
    """The new readers, loaded as the harness loads them (which arms the
    program's tracer); the tracer off and empty afterwards."""
    try:
        yield {n: harness.load_module(ROOT / "benchmark/metrics" / f"{n}.py")
               for n in READERS}
    finally:
        trace.disable()
        trace.take()


def _bursts(monkeypatch, counted):
    """A profiled call, then three burst calls; ``counted`` maps a burst
    call's index to its ``spmm.layout_bytes``."""
    spans = [Span("spmm", 1, None, 1, 0, 5 * US, True)]
    counters = {}
    for k in range(3):
        sid = 10 + k
        t = (10 + 10 * k) * US
        spans.append(Span("dia.layout", 20 + k, sid, sid, t + 1, t + 2,
                          False))
        spans.append(Span("spmm", sid, None, sid, t, t + 5 * US, False))
        if k in counted:
            counters.setdefault("spmm.layout_bytes", {})[sid] = counted[k]
    monkeypatch.setattr(program_trace, "_record", (spans, counters))


def test_layout_bytes_reads_the_bursts_counter(readers, monkeypatch):
    r = readers["layout_bytes.product"]
    run = types.SimpleNamespace(kind="product")
    _bursts(monkeypatch, {0: 524_288_000, 1: 524_288_000, 2: 524_288_000})
    assert r.read(run) == pytest.approx(524.288)
    _bursts(monkeypatch, {0: 0, 1: 0, 2: 0})
    assert r.read(run) == 0.0
    _bursts(monkeypatch, {})                  # a program without it
    assert r.read(run) is None
    monkeypatch.setattr(program_trace, "_record", None)
    monkeypatch.setattr(program_trace, "_trace", None)
    assert r.read(run) is None                # a program without a tracer
    assert r.read(types.SimpleNamespace(kind="solve")) is None


K1 = "(anonymous namespace)::dia_masked_kernel<float>"


def _traced(kernels, products):
    t = devtrace.Trace(window_s=1.0, busy_s=0.5,
                       kernels=[devtrace.Kernel(n, s, 1) for n, s in kernels],
                       device_ops=[], idle_gaps=[])
    return types.SimpleNamespace(
        kind="product", trace=t,
        traced=types.SimpleNamespace(products=products))


def test_layout_ms_reads_the_other_kernels(readers):
    r = readers["layout_ms.product"]
    copy = "elementwise_kernel<128, 4, gpu_kernel_impl_nocast<direct_copy"
    run = _traced([(K1, 0.05), (copy, 0.18), (copy, 0.02)], 200)
    assert r.read(run) == pytest.approx(1.0)  # 0.2 s over 200 calls
    only = _traced([(K1, 0.05)], 200)
    assert r.read(only) == 0.0
    assert r.read(_traced([(copy, 0.2)], 200)) is None
    assert r.read(_traced([], 200)) is None
    assert r.read(types.SimpleNamespace(kind="product", trace=None,
                                        traced=None)) is None
