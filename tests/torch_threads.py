"""Pinned intra-op torch thread counts for the tests of a port test module.

The port's CPU tests run in several pytest-xdist workers at once.  With
torch's default of one intra-op thread per core in every worker, their
thread pools contend for the cores and the tests take several times as
long (scripts/torch_test_durations.py sums them file by file).  A test
module imports ``one_thread`` to run on one thread, or binds
``pin_threads(n)`` to a module name for another count; the previous count
is restored when the module's tests are done.
"""

import pytest
import torch


def pin_threads(n):
    """An autouse module fixture running the module's tests on n
    intra-op threads."""

    @pytest.fixture(autouse=True, scope="module")
    def pinned():
        before = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(before)

    return pinned


one_thread = pin_threads(1)
