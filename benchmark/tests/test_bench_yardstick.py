"""The roofline arithmetic of each configuration and the reading of a
device trace."""

import json
import types

import pytest

import devtrace
import harness
import roofline
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}


def test_hpcg_least_bytes_and_flops():
    cfg = CONFIGS["hpcg-27pt-208"]
    n, nnz = cfg["num_rows"], cfg["nnz"]
    for L in (1, 16):
        # X read once and Y written once, 8 B each; no index or mask word
        assert roofline.least_bytes(cfg, n, nnz, L) == 2 * L * n * 8
        assert roofline.product_flops(nnz, L) == 2 * nnz * L
    # bytes bound it: 144 MB / 3.35 TB/s against 481 MFLOP / 34 TFLOP/s
    assert roofline.least_ms(cfg, n, nnz, 1) == pytest.approx(
        2 * n * 8 / 3.35e12 * 1e3)
    assert roofline.least_ms(cfg, n, nnz, 16) == pytest.approx(0.68768,
                                                               rel=1e-4)


def test_rmat_least_bytes_and_flops():
    cfg = CONFIGS["graph500-rmat-s25"]
    n, nnz = cfg["num_rows"], cfg["nnz"]
    assert n == 1 << cfg["scale"] and nnz == 2 * cfg["edgefactor"] * n
    for L in (1, 32):
        assert roofline.least_bytes(cfg, n, nnz, L) == (
            nnz * (4 + 4) + (n + 1) * 4 + 2 * n * L * 4)
    assert roofline.least_ms(cfg, n, nnz, 1) == pytest.approx(2.68435,
                                                              rel=1e-4)
    assert roofline.least_ms(cfg, n, nnz, 32) == pytest.approx(5.16838,
                                                               rel=1e-4)


def test_every_cell_names_a_known_type_and_least_bytes():
    for cfg in CONFIGS.values():
        assert cfg["dtype"] in roofline.H100_FLOPS_PER_S
        assert set(cfg["least_bytes"]) >= {"per_nonzero", "per_row_offset",
                                           "per_row_lane"}


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_busy_gaps_and_names():
    trace = {"traceEvents": [
        _ev(devtrace.WINDOW, "user_annotation", 100, 100),
        _ev("aten::mul", "cpu_op", 100, 20),
        _ev("cudaLaunchKernel", "cuda_runtime", 102, 5),
        _ev("aten::sum", "cpu_op", 150, 30),
        _ev("void (anonymous namespace)::dia_masked_kernel<double>(unsigned "
            "int const*, double const*)", "kernel", 120, 10, tid=7,
            grid=[4, 2, 1]),
        _ev("void at::native::reduce_kernel<512, 1>(at::native::R)",
            "kernel", 125, 15, tid=7),
        _ev("Memcpy DtoH", "gpu_memcpy", 185, 5, tid=7),
        _ev("outside", "kernel", 300, 50, tid=7),
    ]}
    t = devtrace.parse(trace)
    assert t.window_s == pytest.approx(100e-6)
    # busy: [120, 140] and [185, 190]
    assert t.busy_s == pytest.approx(25e-6)
    assert devtrace.idle_pct(t) == pytest.approx(75.0)
    assert len(t.kernels) == 2
    assert [k.blocks for k in t.kernels] == [8, None]
    assert t.kernel_seconds(roofline.PRODUCT_KERNELS) == pytest.approx(10e-6)
    assert t.kernel_seconds(roofline.PRODUCT_KERNELS,
                            invert=True) == pytest.approx(15e-6)
    assert t.device_ops[0] == ("reduce_kernel<512, 1>",
                               pytest.approx(15e-6))
    # gaps [100, 120] (mid 110: aten::mul), [140, 185] (mid 162.5:
    # aten::sum), [190, 200] (mid 195: only the window)
    gaps = dict(t.idle_gaps)
    assert gaps["aten::mul"] == pytest.approx(20e-6)
    assert gaps["aten::sum"] == pytest.approx(45e-6)
    assert gaps["(host: no op running)"] == pytest.approx(10e-6)


def _blas1_run(grids):
    """A traced run of 2 iterations: a product kernel, an add over a
    vector, a transpose's copy, a fill and a per-lane divide."""
    names = ["(anonymous namespace)::dia_masked_kernel<double>",
             "vectorized_elementwise_kernel<2, CUDAFunctor_add<double>>",
             "elementwise_kernel<128, 2, gpu_kernel_impl_nocast<"
             "direct_copy_kernel_cuda",
             "vectorized_elementwise_kernel<4, FillFunctor<double>>",
             "vectorized_elementwise_kernel<2, DivFunctor<double>>"]
    kernels = [devtrace.Kernel(n, 1e-3 * (i + 1), g)
               for i, (n, g) in enumerate(zip(names, grids))]
    trace = devtrace.Trace(1.0, 0.5, kernels, [], [])
    cell = types.SimpleNamespace(kind="solve")
    return types.SimpleNamespace(
        kind="solve", cell=cell, trace=trace,
        traced=types.SimpleNamespace(iterations=[2]))


def test_blas1_counts_only_passes_over_vectors():
    blas1 = harness.load_module(ROOT / "benchmark/metrics"
                                / "blas1_ms_per_iter.py")
    multi = harness.load_module(ROOT / "benchmark/metrics"
                                / "blas1_ms_per_iter.multi.py")
    run = _blas1_run([4096, 8192, 8192, 8192, 1])
    # only the add: 2 ms over 2 iterations
    assert blas1.read(run) == pytest.approx(1.0)
    assert multi.read(run) == pytest.approx(1.0)
    assert blas1.read(_blas1_run([4096, 8192, 8192, 8192, None])) is None


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        devtrace.parse({"traceEvents": []})


def test_product_kernel_names_match_the_sources():
    """Every kernel of tpusparse_torch/csrc that computes a product or
    its fix-up is in PRODUCT_KERNELS; the permutation is not."""
    import re

    names = set()
    for src in (ROOT / "tpusparse_torch/csrc").glob("*.cu"):
        names |= set(re.findall(r"^(\w+_kernel)\(", src.read_text(), re.M))
    rx = re.compile(roofline.PRODUCT_KERNELS)
    assert names, "no kernels found"
    for name in names:
        assert bool(rx.search(name)) == (name != "permute_rows_kernel"), name
