"""Settings of the benchmark's CPU tests (``benchmark/tests``) for the
configurations added after ``tests/conftest.py``'s ``TINY`` was
written: the tiny size of each, which ``pytest`` merges into that
``TINY`` when it loads the conftest, so ``tiny_root`` cuts every
configuration of ``BENCHMARK.json``."""

from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"
TINY = {"grid3d-7pt-160": {"nx": 7, "ny": 5, "nz": 4}}


def pytest_plugin_registered(plugin):
    path = getattr(plugin, "__file__", None)
    if path and Path(path).resolve() == TESTS / "conftest.py":
        for name, sizes in TINY.items():
            plugin.TINY.setdefault(name, sizes)
