"""One torch thread for a port test file's tests.

The plain kernels are many small eager ops, and with torch's default of
a thread per core in each of the suite's parallel workers every op waits
on threads the other workers hold.  A file takes the cap with

    from _torch_threads import one_torch_thread  # noqa: F401
    pytestmark = pytest.mark.usefixtures("one_torch_thread")
"""
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for the module's tests, torch's setting restored
    after them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
