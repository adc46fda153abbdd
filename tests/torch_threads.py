"""The port's test files' shared autouse fixture (imported into each): two
intra-op PyTorch threads while a file's tests and module fixtures run. The
suite runs six workers at once on a few cores, and PyTorch's default of one
thread per core in each worker oversubscribes them many times over.

Imported by its own name (``from torch_threads import ...``): pytest puts
``tests/`` on ``sys.path`` for the files in it, and a ``tests`` package that
another distribution installs would shadow ``tests.torch_threads``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
