"""pytest settings of the benchmark's own tests (benchmark/tests/).

The `card` marker: a test that needs a CUDA device. It skips, with a reason,
where torch sees none; the decision is made inside the test (the `card`
fixture), never while a module is imported.
"""

import pytest


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)      # several test workers share the cores
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the card: see "
        "benchmark/README.md)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none here")
    return "cuda"
