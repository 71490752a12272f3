"""A fixture and a helper shared by the port's CPU tests
(``tests/test_torch_*.py``)."""
import os

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


def tree_bytes(root: str, skip=("plots",)) -> dict:
    """{path relative to ``root``: bytes} of every file under ``root``,
    leaving out the directories named in ``skip`` (a PDF carries the time
    it was made)."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in skip]
        for name in filenames:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def run_in(cwd: str, main, argv, **kwargs) -> int:
    """``main(argv)`` from ``cwd`` (made if missing): a run that names its
    database and store by relative paths writes the same ``.parameters``
    bytes (which record the paths) in sibling directories."""
    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return main(argv, **kwargs)
    finally:
        os.chdir(here)
