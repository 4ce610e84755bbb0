"""Settings of the benchmark's own tests (``python -m pytest perfbench``):
the checkout's root on the path, and the ``card`` marker of tests that
need a CUDA card, which decide inside the test whether there is one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
