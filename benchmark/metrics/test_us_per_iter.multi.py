"""test_us_per_iter.multi: ``test_us_per_iter`` of the blocked (L > 1)
solve cells, which report ``solve_ms.multi``."""

from pathlib import Path

import harness

read = harness.load_module(
    Path(__file__).with_name("test_us_per_iter.py")).read
