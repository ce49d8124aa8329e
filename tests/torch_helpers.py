"""Shared fixtures and inputs of the tests of nanocall_tpu_torch."""

import numpy as np
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


def random_block_table(rng, deg: int, values: int, groups: int):
    """A (deg, 4096) table of random states whose every (slot, block of
    4096 / groups states) holds `values` distinct log-probs of its own (one
    of them -inf padding), on random states: values x groups in a slot."""
    n = 4096
    w = n // groups
    idx = rng.integers(0, n, (deg, n)).astype(np.int32)
    lp = np.empty((deg, n), np.float32)
    for g in range(groups):
        pool = np.log(rng.uniform(0.01, 1.0, (deg, values))).astype(
            np.float32)
        pool[:, 0] = -np.inf
        pick = np.concatenate([np.tile(np.arange(values), (deg, 1)),
                               rng.integers(0, values, (deg, w - values))], 1)
        lp[:, g * w:(g + 1) * w] = np.take_along_axis(
            pool, rng.permuted(pick, axis=1), axis=1)
    return idx, lp
