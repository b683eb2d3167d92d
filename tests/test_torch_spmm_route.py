"""``spmm`` on a masked band picks its kernel from X's layout, in the
dispatch layer (``ops/spmv.py``).

A row-major float32 X (n, L) with 2 <= L <= 128 runs K7 on the band as
it is, with no copy of X to (L, n), and Y comes back row-major; every
other X runs K1 or K1d on X.T as before. The route follows the operand,
not the device, so here on the CPU it runs K7's plain version, which
equals K1's plain version on X.T bit for bit, as the kernels do on the
card. Each call is held to today's answer, the transposed product on
X.T, bit for bit, and to its counts: ``spmm.nmajor`` where the route is
taken, ``spmm.layout_bytes`` and the ``dia.layout`` span as before.

No JAX."""

import numpy as np
import pytest
import torch

from tpusparse_torch import plan_kind, plan_matrix, spmm
from tpusparse_torch.formats.dia import DiaDevice
from tpusparse_torch.io import generators as gen
from tpusparse_torch.kernels.dia_stream import (
    DiaStreamDevice,
    spmm_dia_planes_t,
    spmm_dia_stream_t,
)
from tpusparse_torch.kernels.spmm_merge import merge_matmat
from tpusparse_torch.utils import trace
from test_torch_trace import tracer  # noqa: F401 (a fixture)


def _plan(dtype=np.float32, matrix=None):
    csr = matrix or gen.make_laplacian_grid3d(7).to_csr()   # 343 rows
    return plan_matrix(csr, "auto", dtype=dtype, device="cpu")


def _x(shape, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def _transposed(D, X):
    """Today's answer: the transposed product on a contiguous X.T."""
    XT = X.to(D.vals.dtype).T.contiguous()
    return spmm_dia_stream_t(D, XT).T


def _counted(P, X, **kw):
    """Y of ``spmm(P, X)`` and the call's counters and span names."""
    trace.take()
    Y = spmm(P, X, **kw)
    spans, counters = trace.take()
    (root,) = [s for s in spans if s.parent is None]
    assert all(v.keys() == {root.id} for v in counters.values())
    return Y, {k: v[root.id] for k, v in counters.items()}, \
        [s.name for s in spans]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64-cast"])
@pytest.mark.parametrize("L", [2, 3, 16, 128])
def test_row_major_float32_block_takes_k7_as_it_is(tracer, L, dtype):
    """A float64 X is cast to the plan's float32 first, which gives a
    row-major block too."""
    P = _plan()
    assert plan_kind(P) == "dia" and isinstance(P.dia, DiaStreamDevice)
    n = P.dia.num_rows
    X = _x((n, L), dtype, seed=L)
    Y, counters, names = _counted(P, X)
    assert Y.shape == (n, L) and Y.dtype == torch.float32
    assert Y.is_contiguous()
    assert torch.equal(Y, _transposed(P.dia, X))
    assert counters == {"spmm.nmajor": 1, "spmm.layout_bytes": 0}
    assert "dia.layout" not in names


def _strided(n):
    """An X (n, 3) that is neither row-major nor an (L, n) block's
    transposed view: every other column of an (n, 6) block."""
    return _x((n, 6), seed=5)[:, ::2]


# name -> (plan, X of n rows, spmm.layout_bytes the call counts)
KEPT = {
    # L = 1: X.T is contiguous already
    "L1": (_plan, lambda n: _x((n, 1)), lambda n: 0),
    # a 1-D X, taken as L = 1
    "1-D": (_plan, lambda n: _x(n), lambda n: 0),
    # an (L, n) block seen as (n, L): X.T is contiguous already
    "XT.T": (_plan, lambda n: _x((3, n)).T, lambda n: 0),
    # past K7's widest block
    "L129": (_plan, lambda n: _x((n, 129)), lambda n: 2 * n * 129 * 4),
    # K7 is float32 only: K1d
    "float64": (lambda: _plan(np.float64),
                lambda n: _x((n, 16), torch.float64),
                lambda n: 2 * n * 16 * 8),
    # neither layout: one copy, to (L, n), on K1's route
    "strided": (_plan, _strided, lambda n: 2 * n * 3 * 4),
    # value planes: K5
    "planes": (lambda: _plan(matrix=gen.make_variable_stencil(5).to_csr()),
               lambda n: _x((n, 16)), lambda n: 2 * n * 16 * 4),
}


@pytest.mark.parametrize("name", list(KEPT))
def test_other_blocks_keep_the_transposed_product(tracer, name):
    plan, make_x, moved = KEPT[name]
    P = plan()
    n = P.dia.num_rows
    X = make_x(n)
    Y, counters, names = _counted(P, X)
    assert Y.shape == X.shape
    assert "spmm.nmajor" not in counters
    X2 = X.reshape(n, -1)
    want = {"spmm.layout_bytes": moved(n)}
    if isinstance(P.dia, DiaDevice):
        # one K5 product: K float32 planes, X (L, n) read, Y written
        want.update({"dia.planes_calls": 1, "dia.planes_bytes": (
            len(P.dia.offsets) + 2 * X2.shape[1]) * n * 4})
    assert counters == want
    assert names.count("dia.layout") == (1 if moved(n) else 0)
    if isinstance(P.dia, DiaDevice):
        want = spmm_dia_planes_t(P.dia, X2.T.contiguous()).T
    else:
        want = _transposed(P.dia, X2)
    assert torch.equal(Y.reshape(n, -1), want)


def test_float32_hybrid_with_a_remainder_gives_the_same_bits(tracer):
    """The DIA part takes K7, the remainder K3's plain version; their sum
    is what the DIA part on X.T plus the remainder gave."""
    P = _plan(matrix=gen.make_wheel(300).to_csr())
    assert plan_kind(P) == "hybrid_dia" and P.rest is not None
    assert isinstance(P.dia, DiaStreamDevice)
    X = _x((P.dia.num_rows, 16), seed=3)
    Y, counters, _ = _counted(P, X)
    want = _transposed(P.dia, X) + merge_matmat(P.rest, X)
    assert torch.equal(Y, want)
    assert counters["spmm.nmajor"] == 1


@pytest.mark.parametrize("L", [1, 16], ids=["K1", "K7"])
@pytest.mark.parametrize("alpha,beta", [(2.5, 0.0), (1.0, -0.5),
                                        (-3.0, 0.25)])
def test_alpha_and_beta_on_either_route(tracer, L, alpha, beta):
    P = _plan()
    n = P.dia.num_rows
    X, Y0 = _x((n, L), seed=1), _x((n, L), seed=2)
    Y, counters, _ = _counted(P, X, alpha=alpha, beta=beta, Y=Y0)
    assert counters.get("spmm.nmajor", 0) == (1 if L > 1 else 0)
    AX = _transposed(P.dia, X)
    want = alpha * AX if beta == 0.0 else alpha * AX + beta * Y0
    assert torch.equal(Y, want)
