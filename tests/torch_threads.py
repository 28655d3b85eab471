"""A module-scoped autouse fixture that runs torch's CPU ops on one thread.

The suite runs in several processes at once (pytest-xdist); an OpenMP pool
as wide as the machine in each of them makes every parallel op wait on
threads that the other processes hold. The port's heavy test files import
it: `from torch_threads import one_torch_thread  # noqa: F401`."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
