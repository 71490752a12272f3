"""A fixture shared by the port's CPU tests (``tests/test_torch_*.py``)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch CPU ops on one intra-op thread, and give the
    process its thread count back after the module.

    The suite runs in several worker processes at once (pytest-xdist), and
    each worker's torch would take every core: its threads then spin
    against each other's. The plain sweep over the real slab of
    ``test_torch_l2_sweep.py`` takes 2.5 s alone on 8 threads (8 s on one),
    but did not finish in 900 s with six such processes at once on 8
    cores; on one thread each, all six took 6-8 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
