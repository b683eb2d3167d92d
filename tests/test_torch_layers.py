"""The port's layers: the direction of their imports, the one epilogue of
the dispatch layer, and the one geometry check of the launch layer.

  * imports point one way, ``solvers/`` -> ``ops/`` -> ``kernels/``:
    no kernel module imports ``ops`` or ``solvers``, no solver imports a
    kernel module, and no kernel module imports another inside a
    function;
  * ``spmv`` and ``spmm`` on every operand type, under the alpha/beta
    pairs (1, 0), (2, 0), (1, 1) and (-0.5, 2), equal bit for bit the
    unscaled kernel-level product scaled by the one rule: Y_new itself
    at alpha = 1, alpha * Y_new otherwise, when beta = 0 or there is no
    Y, and alpha * Y_new + beta * Y in every other case;
  * ``_build.geometry``: every kernel with a geometry mirror (K1, K1d,
    K5 on float32 or bf16 planes, K5d, K7, K2's tile, K3's group
    stretch) refuses a stand-in library of another geometry before it
    launches anything, and reaches its launch with the mirror's own.

Everything runs on the CPU through the plain versions; no JAX."""

import ast
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusparse_torch import plan_dia_bf16, plan_matrix, spmm, spmv
from tpusparse_torch.formats.dia import (
    partition_dia,
    select_diagonals,
    to_device_dia,
)
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import (
    _build,
    bsr,
    dia_nmajor,
    dia_stream,
    ell_spmm,
    merge_spmv,
    spmm_merge,
)
from tpusparse_torch.kernels.csr_reference import (
    csr_matmat_plain,
    csr_matvec_plain,
)
from tpusparse_torch.kernels.permute import permute_apply

PKG = Path(__file__).resolve().parent.parent / "tpusparse_torch"


def _imports(path: Path):
    """(module, inside a function) for every module an import statement
    of ``path`` names: ``from a.b import c`` names a.b and a.b.c."""
    found = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                found.extend((a.name, inner) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module:
                found.append((child.module, inner))
                found.extend((f"{child.module}.{a.name}", inner)
                             for a in child.names)
            visit(child, inner)

    visit(ast.parse(path.read_text()), False)
    return found


RULES = {
    "kernels-import-no-ops-or-solvers": (
        "kernels", lambda mod, _: mod.startswith(
            ("tpusparse_torch.ops", "tpusparse_torch.solvers"))),
    "solvers-import-no-kernels": (
        "solvers", lambda mod, _: mod.startswith("tpusparse_torch.kernels")),
    "no-function-level-import-between-kernels": (
        "kernels", lambda mod, inner: inner and mod.startswith(
            "tpusparse_torch.kernels")),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_imports_point_one_way(rule):
    package, breaks = RULES[rule]
    files = sorted((PKG / package).glob("*.py"))
    assert files
    bad = [f"{f.name}: {mod}" for f in files
           for mod, inner in _imports(f) if breaks(mod, inner)]
    assert bad == []


def _x(shape, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def _band_only(csr, dtype):
    """The masked band of ``csr``'s AUTO plan (a DiaStreamDevice)."""
    return plan_matrix(csr, "auto", dtype=dtype, device="cpu").dia


def _planes(csr, plane_dtype):
    host, rest = partition_dia(csr, select_diagonals(csr))
    assert rest.nnz == 0
    return to_device_dia(host, "cpu", plane_dtype=plane_dtype)


LAP = gen.make_laplacian_grid3d(5).to_csr()          # a masked band
VAR = gen.make_variable_stencil(4).to_csr()          # value planes
RMAT = gen.make_rmat_spd(7).to_csr()                 # scattered
WHEEL = gen.make_wheel(200).to_csr()                 # band + remainder

# operand type -> (operand, the matrix it holds, the type x is cast to)
OPERANDS = {
    "DiaStreamDevice": lambda: (_band_only(LAP, np.float32), LAP,
                                torch.float32),
    "DiaStreamDevice-f64": lambda: (_band_only(LAP, np.float64), LAP,
                                    torch.float64),
    "DiaDevice": lambda: (_planes(VAR, torch.float32), VAR, torch.float32),
    "DiaDevice-bf16": lambda: (_planes(VAR, torch.bfloat16), VAR,
                               torch.float32),
    "DiaDevice-f64": lambda: (_planes(VAR, torch.float64), VAR,
                              torch.float64),
    "DiaNMajorDevice": lambda: (plan_matrix(LAP, "nmajor", L=4,
                                            dtype=np.float32,
                                            device="cpu").dia, LAP,
                                torch.float32),
    "MergeDevice": lambda: (plan_matrix(RMAT, "merge", dtype=np.float32,
                                        device="cpu"), RMAT, torch.float32),
    "MergeDevice-f64": lambda: (plan_matrix(RMAT, "merge", device="cpu"),
                                RMAT, torch.float64),
    "RowSplitDevice": lambda: (plan_matrix(RMAT, "row_split",
                                           dtype=np.float32, device="cpu"),
                               RMAT, torch.float32),
    "BcsrMatrix": lambda: (plan_matrix(RMAT, "bsr", dtype=np.float32,
                                       device="cpu"), RMAT, torch.float32),
    "CsrMatrix": lambda: (plan_matrix(RMAT, "reference", dtype=np.float32,
                                      device="cpu"), RMAT, torch.float32),
    "HybridPlan": lambda: (plan_matrix(WHEEL, "auto", dtype=np.float32,
                                       device="cpu"), WHEEL, torch.float32),
    "HybridPlan-bf16": lambda: (plan_dia_bf16(VAR, device="cpu"), VAR,
                                torch.float32),
    "ReorderedPlan": lambda: (plan_matrix(RMAT, "auto", device="cpu",
                                          reorder="rcm"), RMAT,
                              torch.float64),
}


def _kernel(A, X):
    """A @ X (X (num_cols, L), in the operand's type) by the kernel-level
    entries alone, unscaled. A masked band takes K1 on X.T, which K7,
    where the dispatch layer picks it, equals bit for bit."""
    name = type(A).__name__
    if name == "ReorderedPlan":
        return permute_apply(A.inv_perm,
                             _kernel(A.inner, permute_apply(A.perm, X)))
    if name == "HybridPlan":
        Y = _kernel(A.dia, X)
        return Y if A.rest is None else Y + _kernel(A.rest, X)
    XT = X.T.contiguous()
    if name == "DiaStreamDevice":
        return dia_stream.spmm_dia_stream_t(A, XT).T
    if name == "DiaDevice":
        return dia_stream.spmm_dia_planes_t(A, XT).T
    if name == "DiaNMajorDevice":
        return dia_nmajor.nmajor_matmat(A.band, X.contiguous())
    if name == "MergeDevice":
        return spmm_merge.merge_matmat(A, X.contiguous())
    if name == "RowSplitDevice":
        return ell_spmm.row_split_matmat(A, X.contiguous())
    if name == "BcsrMatrix":
        return bsr.bsr_matmat(A, X.contiguous())
    return csr_matmat_plain(A.num_rows, A.row_offsets, A.col_indices,
                            A.values, X)


def _kernel_vector(A, x):
    """A @ x by the kernel-level entries, unscaled: the vector kernels
    (K1's, K5's and K7's at L = 1, K2, the reference's vector product)
    where the operand has one, else its block product on one column."""
    name = type(A).__name__
    if name == "ReorderedPlan":
        return permute_apply(A.inv_perm,
                             _kernel_vector(A.inner,
                                            permute_apply(A.perm, x)))
    if name == "HybridPlan":
        y = _kernel_vector(A.dia, x)
        return y if A.rest is None else y + _kernel_vector(A.rest, x)
    if name == "DiaStreamDevice":
        return dia_stream.spmm_dia_stream_t(A, x[None].contiguous())[0]
    if name == "DiaDevice":
        return dia_stream.spmm_dia_planes_t(A, x[None].contiguous())[0]
    if name == "MergeDevice":
        return merge_spmv.merge_matvec(A, x)
    if name == "CsrMatrix":
        return csr_matvec_plain(A.num_rows, A.row_offsets, A.col_indices,
                                A.values, x)
    return _kernel(A, x[:, None])[:, 0]


def _scaled(Y_new, alpha, beta, Y):
    if beta == 0.0 or Y is None:
        return Y_new if alpha == 1.0 else alpha * Y_new
    return alpha * Y_new + beta * Y


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.0, 0.0), (1.0, 1.0),
                                        (-0.5, 2.0)])
@pytest.mark.parametrize("product", ["spmv", "spmm"])
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_products_scale_the_kernel_product_by_one_rule(operand, product,
                                                       alpha, beta):
    A, csr, dtype = OPERANDS[operand]()
    assert type(A).__name__ == operand.split("-")[0]
    n, m = csr.num_rows, csr.num_cols
    if product == "spmv":
        x, y0 = _x(m, dtype, seed=1), _x(n, dtype, seed=2)
        got = spmv(A, x, alpha=alpha, beta=beta, y=y0)
        want = _scaled(_kernel_vector(A, x), alpha, beta, y0)
    else:
        X, Y0 = _x((m, 3), dtype, seed=3), _x((n, 3), dtype, seed=4)
        got = spmm(A, X, alpha=alpha, beta=beta, Y=Y0)
        want = _scaled(_kernel(A, X), alpha, beta, Y0)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


class StandIn:
    """Stand-in for the CUDA library: the mirrors' geometry, with
    ``rows_skew`` more rows a thread for K1, K5 and K7, none for K1's and
    K5's value size (``known=False``), K2's tile ``tile`` merge items and
    ``group_skew`` more in K3's group stretch. A kernel entry raises
    AssertionError: reaching it means the geometry passed."""

    def __init__(self, rows_skew=0, known=True,
                 tile=merge_spmv.TILE_ITEMS, group_skew=0):
        self.rows_skew, self.known = rows_skew, known
        self.tile, self.group_skew = tile, group_skew

    def _fill(self, out, values):
        values = list(values)
        values[1] += self.rows_skew
        (ctypes.c_int * len(values)).from_address(out)[:] = values
        return 0

    def tps_dia_masked_geometry(self, value_bytes, out):
        return (self._fill(out, dia_stream.k1_geometry(value_bytes))
                if self.known else 1)

    def tps_dia_planes_geometry(self, value_bytes, out):
        return (self._fill(out, dia_stream.k5_geometry(value_bytes))
                if self.known else 1)

    def tps_dia_nmajor_geometry(self, out):
        return self._fill(out, (dia_nmajor.K7_THREADS, dia_nmajor.K7_ROWS,
                                dia_nmajor.K7_SUB_BLOCKS,
                                dia_nmajor.K7_VECTOR_BYTES))

    def tps_merge_spmv_tile_items(self):
        return self.tile

    def tps_merge_spmm_group_items(self, L, value_bytes):
        return spmm_merge.group_items(L, value_bytes) + self.group_skew

    def __getattr__(self, name):
        raise AssertionError(f"{name} launched")


@pytest.fixture
def stand_in(monkeypatch):
    """Install a stand-in library with a fresh geometry cache; returns
    the installer, which takes StandIn's arguments."""
    def install(**kw):
        lib = StandIn(**kw)
        monkeypatch.setattr(_build, "library", lambda: lib)
        monkeypatch.setattr(_build, "_geometry", {})
        return lib
    return install


def _k1(dtype):
    D = _band_only(LAP, dtype)
    XT = torch.zeros((2, D.num_cols), dtype=D.vals.dtype)
    return lambda: dia_stream._launch(D, XT)


def _k5(plane_dtype):
    D = _planes(VAR, plane_dtype)
    XT = torch.zeros((2, D.num_cols),
                     dtype=dia_stream.planes_value_dtype(D))
    return lambda: dia_stream._launch_planes(D, XT)


def _k7():
    B = _band_only(LAP, np.float32)
    X = torch.zeros((B.num_rows, 4))
    return lambda: dia_nmajor._launch(B, X)


def _merge(launch, L):
    M = merge_spmv.to_device_merge(RMAT, "cpu")
    X = torch.zeros((M.num_cols, L)) if L else torch.zeros(M.num_cols)
    return lambda: launch(M, X)


# kernel -> (its launch on CPU tensors, the stand-ins it must refuse)
GEOMETRY = {
    "K1": (lambda: _k1(np.float32), ({"rows_skew": 4}, {"known": False})),
    "K1d": (lambda: _k1(np.float64), ({"rows_skew": 4}, {"known": False})),
    "K5": (lambda: _k5(torch.float32), ({"rows_skew": 2}, {"known": False})),
    "K5-bf16": (lambda: _k5(torch.bfloat16),
                ({"rows_skew": 2}, {"known": False})),
    "K5d": (lambda: _k5(torch.float64), ({"rows_skew": 2}, {"known": False})),
    "K7": (_k7, ({"rows_skew": 2}, {"rows_skew": -2})),
    "K2": (lambda: _merge(merge_spmv._launch, 0),
           ({"tile": 2 * merge_spmv.TILE_ITEMS},)),
    "K3": (lambda: _merge(spmm_merge._launch, 16),
           ({"tile": 2 * merge_spmv.TILE_ITEMS}, {"group_skew": 8})),
}


@pytest.mark.parametrize("kernel", list(GEOMETRY))
def test_launch_checks_the_library_geometry(stand_in, kernel):
    """A library of another geometry raises, naming the kernel, the
    library's value and the mirror's, before anything is launched; the
    mirror's own geometry lets the launch through."""
    make, refused = GEOMETRY[kernel]
    launch = make()
    for kw in refused:
        stand_in(**kw)
        with pytest.raises(RuntimeError,
                           match=r"K\d.*geometry.*in the library"):
            launch()
    stand_in()
    with pytest.raises(AssertionError, match="launched"):
        launch()
