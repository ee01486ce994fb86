"""A module-scoped fixture for the port's CPU test files: torch computes
on one intra-op thread while the module's tests run, and gets its thread
count back after them.

The suite runs in several worker processes on a few cores.  With torch's
default of one intra-op thread per core in every worker the cores are
oversubscribed, and its threads then wait on each other at every
parallel region: a test that takes seconds alone took many times as long
beside busy workers, and far less with one thread.  JAX's own thread pool
is not affected.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
