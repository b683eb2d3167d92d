"""Result-comparison utilities (port of ``tpusparse/utils/compare.py``).

A ULP comparator that reinterprets float32 bits as integers and fails
when ``sqrt(max |int_a - int_b|) > len``; float64 is demoted to float32
first, integer types compare exactly.
"""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def ulp_distance(a, b) -> np.ndarray:
    """Per-element distance in units in the last place (fp32 lattice)."""
    ia = np.asarray(_host(a), dtype=np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(_host(b), dtype=np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude float lattice onto a monotone integer line
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def compare_results(computed, reference) -> tuple[bool, int]:
    """PASS when sqrt(max ULP distance) <= len. Returns (ok, index of
    the worst element)."""
    computed = _host(computed)
    reference = _host(reference)
    if computed.dtype.kind in "iu":
        diff = computed != reference
        if diff.any():
            return False, int(np.argmax(diff))
        return True, 0
    if computed.size == 0:
        return True, 0
    d = ulp_distance(computed, reference)
    return bool(np.sqrt(float(d.max())) <= computed.size), int(np.argmax(d))


def assert_close(computed, reference, context: str = "") -> None:
    ok, worst = compare_results(computed, reference)
    if not ok:
        c = _host(computed).ravel()[worst]
        r = _host(reference).ravel()[worst]
        raise AssertionError(
            f"FAIL {context}: element {worst}: computed {c!r} vs "
            f"reference {r!r}")
