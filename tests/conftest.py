import os
import sys

# Tests run on the single real CPU device (the dry-run, and only the dry-run,
# forces 512 host devices in its own process).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card with compute capability >= 9.0 "
        "(skips elsewhere; decided in a fixture, not at import)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)
