"""One torch thread per test process, for the port's test files.

The test run shares the CPU among several pytest-xdist workers. The port's
plain path issues thousands of small torch ops; with torch's default of one
OpenMP thread per core in every worker, the idle threads of each parallel
region spin against the other workers' and the whole run slows down several
fold (a six-worker run on eight cores: 651 s, against 255 s with one thread
per process). A test file imports the fixture to use it:

    from torch_threads import one_torch_thread  # noqa: F401 (autouse)
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
