"""The benchmark's own tests: ``python -m pytest port_bench/tests -q``.

Tests marked ``card`` need an NVIDIA card and skip without one; the check
is made inside the ``card`` fixture, when a test runs, never while a
module is imported. Run them on the card with
``python -m pytest port_bench/tests -q -m card``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark's control and "
                    "timing run only there")
    return torch.device("cuda", 0)
