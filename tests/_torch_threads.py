"""The module fixture that caps PyTorch's intra-op threads in the port's CPU
test files, which import it by name."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads for the module's PyTorch work: the test run puts
    several workers on one host, and PyTorch's default of one thread per
    core then oversubscribes it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
