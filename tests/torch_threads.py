"""A fixture for the port's CPU tests: each module runs with one torch
(OpenMP) thread, and the thread count is restored after it.

The tier-1 suite runs several pytest-xdist workers on the host's cores.
Each worker's torch would start a thread per core, and the oversubscribed
OpenMP threads slow the many small tensor ops of these tests by an order
of magnitude.  Import it into a test module to apply it there:
`from torch_threads import one_torch_thread  # noqa: F401`.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
