"""cg_iters.multi: ``cg_iters`` of the blocked (L > 1) solve cells, which
report ``solve_ms.multi``."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("cg_iters.py")).read
