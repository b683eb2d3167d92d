"""CPU tests of the benchmark: its yardstick at small sizes, and runs of
every cell through the program's plain (CPU) versions.

    python -m pytest benchmark/tests -q

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``benchmark/``) whose configurations are cut to a few hundred rows.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"hpcg-27pt-208": {"nx": 8, "ny": 7, "nz": 6},
        "graph500-rmat-s25": {"scale": 9}}


@pytest.fixture
def tiny_root(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        path = tmp_path / conf["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[conf["name"]])
        path.write_text(json.dumps(cfg))
    return tmp_path


def cell_names():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]
