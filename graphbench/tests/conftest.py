"""Fixtures of the benchmark's CPU tests (the small cells are built in
``smallbench.py``)."""
import pytest
import torch

from smallbench import small_registry


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def small(tmp_path):
    return small_registry(tmp_path)
