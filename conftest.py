"""Settings of the benchmark's CPU tests (``benchmark/tests``) for the
configurations added after ``benchmark/conftest.py``'s ``TINY``: the
tiny size of each, which ``pytest`` merges into ``TINY`` of
``benchmark/tests/conftest.py`` when it loads that conftest, so
``tiny_root`` cuts every configuration of ``BENCHMARK.json``. Other test
runs are left as they are."""

from pathlib import Path

TESTS = Path(__file__).resolve().parent / "benchmark" / "tests"
TINY = {"ceed-bp3-q1-perturbed-160": {"elements": 5}}


def pytest_plugin_registered(plugin):
    path = getattr(plugin, "__file__", None)
    if path and Path(path).resolve() == TESTS / "conftest.py":
        for name, sizes in TINY.items():
            plugin.TINY.setdefault(name, sizes)
