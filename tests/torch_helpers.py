"""Shared fixtures of the tests that run nanocall_tpu_torch on the CPU."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    torch's thread pool per worker would oversubscribe its cores.  A module
    imports this fixture to have it apply to all of its tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
