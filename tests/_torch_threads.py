"""One intra-op thread for a test module's torch work on the CPU.

The suite runs under several pytest-xdist workers at once. A torch op on
a tensor above its grain size opens a parallel region on every core, and
with six workers each spinning a full thread pool the small, frequent
regions of a training loop oversubscribe the machine badly: six copies
of ``tests/test_torch_train_launch.py``'s two 60-step runs took 34 s with
one thread each and did not finish in 900 s with eight, on eight cores.
The tests' tiny tensors gain nothing from more threads (one copy alone
runs in the same time either way). Import the fixture into a test module
to use it; the module's thread count is restored when it ends.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
