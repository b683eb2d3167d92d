"""K6's decomposition of the row permutation (``csrc/permute.cu``)
emulated on the CPU.

The wrapper views a row of x as ``words`` machine words of 4, 8 or 16
bytes, the widest that divides the row and the alignment of x and y
(``permute._word_bytes``), and K6 moves one word a thread: thread e
writes word e of y, word ``e % words`` of row ``perm[e // words]`` of x.
``emulate_k6`` walks the same words in numpy; it equals ``index_select``
bit for bit in float32, float64 and int32, as (n,) and (n, L), at odd L,
on rows of more words than a CTA has threads, and on x whose data starts
off a 16-byte boundary (narrower words). The card tests
(``test_torch_cuda.py``) hold K6 to it. A ``ReorderedPlan`` moves blocks
through the same permutation (``apply_perm``) and back (``apply_inv``).
"""

import numpy as np
import pytest
import torch

from tpusparse_torch.kernels import permute
from tpusparse_torch.ops.reorder import ReorderedPlan

DTYPES = (torch.float32, torch.float64, torch.int32)
# (n, L); L = 0 is a vector (n,)
SHAPES = ((1, 0), (4099, 0), (1023, 1), (1001, 2), (1001, 3), (777, 4),
          (1001, 16), (513, 33), (70, 1030))


def emulate_k6(perm, x, y=None):
    """K6's y = x[perm] (torch tensors on the CPU) word by word, with the
    words the wrapper picks for x and an output ``y`` (a new aligned
    tensor by default)."""
    y = torch.empty_like(x) if y is None else y
    n = x.shape[0]
    row_bytes = x.numel() // n * x.element_size()
    wb = permute._word_bytes(row_bytes, x, y)
    words = row_bytes // wb
    xs = x.contiguous().numpy().view(np.uint8).reshape(n * words, wb)
    e = np.arange(n * words)
    i, w = e // words, e % words
    perm = np.asarray(perm, np.int64)
    ys = xs[perm[i] * words + w]
    return torch.from_numpy(ys.reshape(-1).view(x.numpy().dtype)
                            .reshape(x.shape).copy())


def _x(n, L, dtype, seed):
    shape = (n,) if L == 0 else (n, L)
    x = np.random.default_rng(seed).standard_normal(shape) * 1e3
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,L", SHAPES)
def test_emulated_k6_equals_index_select(n, L, dtype):
    """A random, a reversed and the identity permutation."""
    x = _x(n, L, dtype, n + L)
    for perm in (np.random.default_rng(n).permutation(n),
                 np.arange(n)[::-1].copy(), np.arange(n)):
        np.testing.assert_array_equal(
            emulate_k6(perm, x).numpy(),
            x.index_select(0, torch.from_numpy(perm)).numpy())


@pytest.mark.parametrize("offset", (1, 2, 3))
def test_emulated_k6_on_misaligned_rows(offset):
    """Rows of 16 bytes whose data starts 4, 8 or 12 bytes off a 16-byte
    boundary move as narrower words, exactly."""
    n = 1000
    flat = torch.arange((n + 1) * 4, dtype=torch.float32)
    x = flat[offset:offset + n * 4].view(n, 4)
    perm = np.random.default_rng(1).permutation(n)
    np.testing.assert_array_equal(
        emulate_k6(perm, x).numpy(),
        x.index_select(0, torch.from_numpy(perm)).numpy())


def test_word_bytes_follow_the_row_and_alignment():
    flat = torch.zeros(64 * 16 + 4)
    cases = ((torch.zeros(64, 4), 16), (torch.zeros(64, 2), 8),
             (torch.zeros(64, 3), 4),
             (torch.zeros(64, dtype=torch.float64), 8),
             (torch.zeros(64, 16), 16),
             (flat[2:2 + 64 * 16].view(64, 16), 8),
             (flat[1:1 + 64 * 16].view(64, 16), 4))
    for x, want in cases:
        row_bytes = x.numel() // x.shape[0] * x.element_size()
        assert permute._word_bytes(row_bytes, x, torch.empty_like(x)) == want


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reordered_plan_moves_blocks_both_ways(dtype):
    """``apply_perm`` is ``index_select`` through perm, ``apply_inv``
    through its inverse: the round trip is exact."""
    n = 1001
    perm = np.random.default_rng(3).permutation(n)
    A = ReorderedPlan(n, n, 0, None, permute.build_permute_plan(perm, "cpu"),
                      permute.build_permute_plan(np.argsort(perm), "cpu"))
    for L in (0, 1, 3, 16):
        x = _x(n, L, dtype, 40 + L)
        y = A.apply_perm(x)
        assert torch.equal(y, emulate_k6(perm, x))
        assert torch.equal(A.apply_inv(y), x)
