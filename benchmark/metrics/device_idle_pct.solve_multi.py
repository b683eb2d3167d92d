"""device_idle_pct.solve_multi: ``device_idle_pct.solve`` of the blocked (L > 1) solve
cells, which report ``solve_ms.multi``."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("device_idle_pct.solve.py")).read
