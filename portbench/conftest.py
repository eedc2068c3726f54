"""The benchmark's CPU tests run the program and the reference at tiny
sizes: on one CPU thread, since torch's thread pool spins when the test
workers oversubscribe the cores (ten times slower)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
