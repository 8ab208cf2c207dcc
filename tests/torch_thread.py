"""One torch thread for the port's test files.

Under ``pytest -n 6 --dist loadfile`` every worker would open an intra-op
pool as wide as the machine, and the pools spin against the other workers:
each small op then waits for a scheduler time slice (on an 8-core CPU beside
six busy processes the 30-step ``Workspace`` test of
``tests/test_torch_train.py`` took 275 s with the default pool, 10 s with one
thread). A test file takes the fixture by importing it by name::

    from torch_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
