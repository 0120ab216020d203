"""A fixture for CPU test modules of the port that run many small torch
convolutions. Import it into the module (`from torch_threads import
few_torch_threads`); it applies itself to the whole module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads while the module runs: the tier-1 run has six test
    processes at once, and torch's default of a thread per core in each
    oversubscribes the cores (TINY_YAML train steps then ran 10-60x slower
    than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
