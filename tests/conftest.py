import numpy as np
import pytest

# NOTE: no XLA_FLAGS device override here — smoke tests and benches must see
# exactly 1 device. Multi-device behavior is tested via subprocesses
# (tests/test_distributed.py) which set the flag before importing jax.


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (long randomized stress "
                          "runs that are opt-in, not tier-1)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-horizon / many-seed stress test, opt-in via "
                   "--runslow (a seeded small case of the same invariant "
                   "stays in tier-1)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's hand-written kernels "
                   "have no CPU mode); skips in a fixture when none is present")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
