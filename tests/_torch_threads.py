"""``one_torch_thread``: an autouse fixture that a test module takes by
importing it (``from _torch_threads import one_torch_thread  # noqa: F401``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread for the whole module, its module-scoped fixtures
    included: beside other test processes, torch's default of a thread per
    core oversubscribes the machine and its spinning threads slow the CPU
    convolutions tenfold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
