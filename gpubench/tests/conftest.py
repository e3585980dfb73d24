"""The benchmark's own tests: the harness on the CPU at small sizes, and
(marked ``gpu``) the control at the cells' sizes on a card."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one); run on a "
        "card with python -m pytest -m gpu gpubench/tests")


@pytest.fixture
def card():
    """Skip unless torch finds a CUDA device (decided in the test, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench():
    from gbench import spec
    return spec.load_benchmark()
