"""An autouse fixture for the port's CPU tests: one torch intra-op thread
while a module runs.  The twins work on small tensors, where intra-op
threads cost more than they save (a Poseidon proof takes a fifth longer
with eight threads than with one on an 8-core CPU), and test workers that
share the cores lose less time to each other.  A module takes it with

    from torch_one_thread import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
