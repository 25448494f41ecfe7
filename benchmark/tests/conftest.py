"""CPU tests of the benchmark; the tests marked ``card`` run the cells on
an NVIDIA card and skip, inside the test, where torch sees none:

    python3 -m pytest benchmark/tests -q
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small models on many cores: one thread a test process."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_root(tmp_path):
    from benchmark.tests.tiny import write_root

    return write_root(str(tmp_path))


def needs_card(chips: int = 1) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
