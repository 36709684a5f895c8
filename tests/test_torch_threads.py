"""The port's CPU tests run each test's torch ops on one thread.

The suite runs in several processes at once (``pytest -n``), and PyTorch
spreads an op over every core of the box: the threads of one process then
wait on each other while the other processes hold the cores, far longer
than the op takes (on an 8-core box with 6 processes, tests of thousands of
small ops ran 20-100x slower than alone). Each ``tests/test_torch_*.py``
file that computes with torch imports ``one_torch_thread``, an autouse
fixture that sets one intra-op thread for each of its tests and restores
the count after it. What the tests hold does not depend on the number of
threads.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_test_runs_on_one_thread():
    assert torch.get_num_threads() == 1
