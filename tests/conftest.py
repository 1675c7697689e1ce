import os
import sys

# tests must see ONE cpu device (dry-run sets its own 512-device flag in a
# subprocess); make sure nothing leaks in from the environment.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
                   "elsewhere")
