"""A fixture for the port's QAT, bake and engine test modules: torch runs
their many small CPU ops on one thread.  pytest-xdist runs several workers
on the machine's cores at once, and torch's OpenMP teams, each as wide as
the machine, then wait on each other at every op: on 8 cores with 4
workers, tests/test_torch_{qat,bake,mbv1_engine,float_sim}.py took 587 s
together on the threads torch picks and 65 s on one.  The module's own
setting comes back when it ends."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
