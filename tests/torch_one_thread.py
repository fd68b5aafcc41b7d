"""An autouse fixture for test modules of the port that run many small
CPU episodes: torch on one thread for the test's duration.  Their ops are
tiny, so intra-op threads only add start-up and, with several test
workers on one machine, contend for the cores.

    from tests.torch_one_thread import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
