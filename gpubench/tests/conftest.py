import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    """The tiny runs are launch-bound: several test workers each with every
    core's threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
