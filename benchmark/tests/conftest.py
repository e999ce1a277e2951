"""Tests of the benchmark harness.  CPU tests run anywhere; tests marked
`cuda` need an NVIDIA card and skip without one (the `card` fixture decides,
never an import):

    python3 -m pytest benchmark/tests -q            # on the CPU
    python3 -m pytest benchmark/tests -q -m cuda    # on a card host
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false"
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return "cuda"
