"""Tests of the benchmark harness. Run from the repository's root:

    python -m pytest portbench/tests -q

They import neither JAX nor the JAX package. Tests marked ``cuda`` need the
card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped on a machine without one")
