"""The row-split plan's work-row table and the chunk-ordered plain
version of K4 and K4d (``tpusparse_torch/kernels/ell_spmm.py``).

The table cuts every row longer than C nonzeros into consecutive chunks
of C; these tests hold it to that contract on edge cases (rows of
exactly C, C + 1, 3C and 10C + 3 entries, many split rows of random
lengths, wheel hubs, empty rows, nnz = 0, num_rows = 0, the hub row of
``make_rmat(14, 16)``). The plain version, which the kernels equal bit
for bit, is held to a numpy float32 (or float64) loop that sums each
work row in CSR order and then each row's chunk partials in chunk
order, and to the one-pass CSR-order sum on every row of at most C
nonzeros; against the float64 product, every row stays within
(nnz_i + 2) u (|A||X|)_i. The JAX package's ``row_split`` plan (B5 in
interpret mode) gives the same Y within that bound on a wheel whose hub
is cut into 3 chunks.
"""

import numpy as np
import pytest
import torch

from tpusparse.io import generators as jgen
from tpusparse.ops.spmv import plan_matrix as jplan
from tpusparse.ops.spmv import spmm as jspmm
from tpusparse_torch import CsrMatrix, plan_kind, plan_matrix, spmm
from tpusparse_torch.formats.csr import NUMPY_OF, value_dtype
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels import ell_spmm
from tpusparse_torch.ops.reference import csr_matmat
from tpusparse_torch.utils.carry import plan_from_arrays

C = ell_spmm.ROW_CHUNK
U = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def _rows(lengths, num_cols=None, seed=0) -> CsrMatrix:
    """A CSR matrix whose rows hold ``lengths`` nonzeros at random
    columns (sorted, repeats allowed) with standard normal values."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.int64)
    num_cols = num_cols or max(int(lengths.max(initial=0)), 1)
    ro = np.zeros(lengths.shape[0] + 1, dtype=np.int32)
    np.cumsum(lengths, out=ro[1:])
    cols = np.concatenate([np.sort(rng.integers(0, num_cols, n))
                           for n in lengths] + [np.zeros(0, np.int64)])
    return CsrMatrix(lengths.shape[0], num_cols, ro,
                     cols.astype(np.int32), rng.standard_normal(ro[-1]))


FIXTURES = {
    "C": lambda: _rows([C]),
    "C+1": lambda: _rows([C + 1]),
    "3C": lambda: _rows([3 * C]),
    "mixed": lambda: _rows([0, 3, C, C + 1, 0, 3 * C, 1, 2 * C - 1, 0]),
    "10C+3": lambda: _rows([5, 10 * C + 3, 17]),
    "many-split": lambda: _rows(
        np.random.default_rng(3).integers(0, 5 * C, 60), seed=1),
    "wheel-5000": lambda: gen.make_wheel(5000).to_csr(),
    "empty-rows": lambda: CsrMatrix(6, 5, np.array([0, 0, 2, 2, 2, 3, 3]),
                                    np.array([1, 4, 0]),
                                    np.array([1.0, 2.0, 3.0])),
    "nnz-0": lambda: CsrMatrix(4, 4, np.zeros(5, np.int32),
                               np.zeros(0, np.int32), np.zeros(0)),
    "n-0": lambda: CsrMatrix(0, 3, np.zeros(1, np.int32),
                             np.zeros(0, np.int32), np.zeros(0)),
    "rmat-14": lambda: gen.make_rmat(14, 16).to_csr(),
}


def _table(A):
    T = A.table
    return {k: getattr(T, k).numpy() for k in (
        "work_offsets", "work_dest", "split_rows", "split_offsets")}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_table_covers_every_nonzero_once_cutting_only_long_rows(name):
    csr = FIXTURES[name]()
    A = ell_spmm.to_device_row_split(csr, "cpu")
    B, t = A.table, _table(A)
    ro = np.asarray(csr.row_offsets, dtype=np.int64)
    lengths = np.diff(ro)
    wo, dest = t["work_offsets"], t["work_dest"]
    # a virtual CSR over the same nonzeros: every one exactly once
    assert wo[0] == 0 and wo[-1] == csr.nnz and np.all(np.diff(wo) >= 0)
    assert np.all(np.diff(wo) <= C)
    # a row of at most C nonzeros is one work row that writes it
    pieces = np.maximum(1, -(-lengths // C))
    first = np.concatenate([[0], np.cumsum(pieces)])
    assert first[-1] == B.num_work_rows == dest.shape[0]
    whole = pieces == 1
    assert np.array_equal(dest[first[:-1][whole]], np.flatnonzero(whole))
    assert np.array_equal(wo[first[:-1]], ro[:-1])
    assert np.array_equal(wo[first[1:]], ro[1:])
    # a longer row: consecutive chunks of C nonzeros, in order, whose
    # partial slots are consecutive and listed in the chunk table
    split = np.flatnonzero(~whole)
    assert np.array_equal(t["split_rows"], split)
    so = t["split_offsets"]
    assert so[0] == 0 and so[-1] == B.num_chunks == np.sum(pieces[split])
    for k, i in enumerate(split):
        w = np.arange(first[i], first[i + 1])
        assert np.array_equal(wo[w], ro[i] + C * np.arange(w.shape[0]))
        assert np.array_equal(~dest[w], np.arange(so[k], so[k + 1]))
    assert all(v.dtype == np.int32 for v in t.values())


def test_rmat_hub_row_is_cut_into_chunks():
    csr = FIXTURES["rmat-14"]()
    lengths = np.diff(csr.row_offsets)
    hub = int(np.argmax(lengths))
    A = ell_spmm.to_device_row_split(csr, "cpu")
    t = _table(A)
    k = int(np.flatnonzero(t["split_rows"] == hub)[0])
    assert (t["split_offsets"][k + 1] - t["split_offsets"][k]
            == -(-lengths[hub] // C) > 1)
    assert A.table.num_split == int(np.sum(lengths > C))


def _chunk_ordered(A, X: np.ndarray) -> np.ndarray:
    """Numpy in the values' type: each work row summed in CSR order from
    +0, then each row's partials summed in chunk order from +0."""
    t = _table(A)
    wo, dest = t["work_offsets"].astype(np.int64), t["work_dest"]
    cols = A.col_indices.numpy()
    vals = A.values.numpy()
    lens = np.diff(wo)
    part = np.zeros((lens.shape[0], X.shape[1]), dtype=vals.dtype)
    for k in range(int(lens.max(initial=0))):
        sel = lens > k
        j = wo[:-1][sel] + k
        part[sel] = part[sel] + vals[j, None] * X[cols[j]]
    Y = np.zeros((A.num_rows, X.shape[1]), dtype=vals.dtype)
    Y[dest[dest >= 0]] = Y[dest[dest >= 0]] + part[dest >= 0]
    so = t["split_offsets"].astype(np.int64)
    slots = part[dest < 0]          # chunk rows in slot order
    nk = np.diff(so)
    for k in range(int(nk.max(initial=0))):
        sel = nk > k
        rows = t["split_rows"][sel]
        Y[rows] = Y[rows] + slots[so[:-1][sel] + k]
    return Y


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_is_chunk_ordered_bitwise(name, L, dtype):
    csr = FIXTURES[name]()
    A = ell_spmm.to_device_row_split(csr, "cpu", dtype)
    X = np.random.default_rng(L).standard_normal(
        (csr.num_cols, L)).astype(NUMPY_OF[dtype])
    Y = ell_spmm.row_split_matmat(A, torch.from_numpy(X))
    assert Y.dtype == dtype and Y.shape == (csr.num_rows, L)
    np.testing.assert_array_equal(Y.numpy(), _chunk_ordered(A, X))
    # rows of at most C nonzeros: the one-pass CSR-order sum, bitwise
    Y1 = csr_matmat(A.num_rows, A.row_offsets, A.col_indices, A.values,
                    torch.from_numpy(X))
    short = torch.from_numpy(np.diff(csr.row_offsets) <= C)
    assert torch.equal(Y[short], Y1[short])
    # every row within (nnz_i + 2) u |A||X| of the float64 product
    S = csr.to_scipy().astype(np.float64)
    exact = S @ X.astype(np.float64)
    ax = abs(S) @ np.abs(X.astype(np.float64))
    nnz_i = np.diff(csr.row_offsets)[:, None]
    assert np.all(np.abs(Y.numpy().astype(np.float64) - exact)
                  <= (nnz_i + 2) * U[dtype] * ax)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_carried_row_split_plan_builds_the_same_table(dtype):
    csr = FIXTURES["rmat-14"]()
    own = plan_matrix(csr, "row_split", dtype=dtype, L=16, device="cpu")
    carried = plan_from_arrays("row_split", {
        "row_offsets": csr.row_offsets, "col_indices": csr.col_indices,
        "values": csr.values, "shape": csr.shape}, "cpu",
        value_dtype(dtype))
    assert plan_kind(own) == plan_kind(carried) == "row_split"
    assert own.table.num_chunks == carried.table.num_chunks > 0
    for k, v in _table(own).items():
        np.testing.assert_array_equal(_table(carried)[k], v)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (csr.num_cols, 4)).astype(dtype))
    assert torch.equal(spmm(own, X), spmm(carried, X))


def test_plain_needs_the_table():
    csr = FIXTURES["mixed"]()
    A = ell_spmm.to_device_row_split(csr, "cpu")
    bare = ell_spmm.RowSplitDevice(A.num_rows, A.num_cols, A.row_offsets,
                                   A.col_indices, A.values)
    with pytest.raises(ValueError, match="work-row table"):
        ell_spmm.row_split_matmat(bare, torch.zeros(A.num_cols, 2))


def test_table_must_be_int32_on_the_operands_device():
    csr = FIXTURES["mixed"]()
    A = ell_spmm.to_device_row_split(csr, "cpu")
    A.table.work_dest = A.table.work_dest.to(torch.int64)
    with pytest.raises(ValueError, match="work-row table"):
        ell_spmm.row_split_matmat(A, torch.zeros(A.num_cols, 2))


def test_split_wheel_hub_matches_jax_row_split():
    L = 3
    jcsr, csr = jgen.make_wheel(600).to_csr(), gen.make_wheel(600).to_csr()
    X = np.random.default_rng(8).standard_normal(
        (csr.num_cols, L)).astype(np.float32)
    A = ell_spmm.to_device_row_split(csr, "cpu")
    assert A.table.num_chunks == 3
    Y = spmm(A, torch.from_numpy(X)).numpy()
    Yj = np.asarray(jspmm(jplan(jcsr, "row_split", dtype=np.float32, L=L),
                          X))
    S = csr.to_scipy().astype(np.float64)
    ax = abs(S) @ np.abs(X.astype(np.float64))
    nnz_i = np.diff(csr.row_offsets)[:, None]
    assert np.all(np.abs(Y.astype(np.float64) - Yj) <= 2 * (nnz_i + 2)
                  * U[torch.float32] * ax)
