"""solve_ms.multi: ``solve_ms`` of the blocked (L > 1) solve cells, the
window's wall time over the solves it completed, under a bound of its
own."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("solve_ms.py")).read
