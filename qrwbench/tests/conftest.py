"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`card` that run only where a CUDA device is present (run them on the
card with `python3 -m pytest qrwbench/tests -m card`)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "interpret mode)")
    return "cuda"
