"""One intra-op thread for the port's CPU tests.

The test command runs six pytest-xdist workers on the machine's cores, and
torch's default intra-op pool takes a thread a core in every worker: six
pools contend for the cores, and their OpenMP threads spin waiting for each
other. A test of many small ops burns several times its single-thread CPU
for no gain (the fp32 flash kernel's model, ``_torch_tf32_model.py``, at
(96, 64) on an 8-core host: 4.1 s and 24 CPU-seconds at 8 threads,
4.5 s and 4.5 CPU-seconds at one). A test module that imports
``one_torch_thread`` runs its tests, and its module-scoped fixtures, on one
intra-op thread and restores the count after; the spawned ranks of the
multi-rank tests set one thread themselves.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
