"""One intra-op thread for the port's tests: an autouse fixture that a test
module imports (``from torch_threads import one_torch_thread``).

The port's plain path at test sizes is thousands of small ops: one
intra-op thread runs it as fast as eight alone, and keeps the test
workers that share the machine from spinning against each other. With
six workers on eight cores, eight threads a worker ran the demo's three
small frames ~9x slower than one thread did."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
