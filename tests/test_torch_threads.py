"""One torch intra-op thread for each test module of the port that
imports ``one_thread`` from here (an autouse module fixture).

The tier-1 run gives each of its parallel workers a module at a time; a
worker that lets torch use every core oversubscribes the host six times
over, while at the tests' small maps one thread is about as fast alone.
The previous count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
