"""The benchmark's CPU tests run several to a machine (pytest-xdist): one
torch thread each keeps their tiny runs from fighting over the cores."""

import pytest


@pytest.fixture(autouse=True, scope="session")
def _one_torch_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
