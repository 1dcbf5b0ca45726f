"""A module-scoped fixture that runs a test module of the PyTorch port on one
CPU thread and restores the thread count after it.

The port's plain twins at test sizes are many small tensor operations,
which run several times faster on one thread than on eight.  Import it into
a test module to apply it there::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
