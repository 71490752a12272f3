"""Which of the engine's phases sets a benchmark cell's peak device memory.

Runs the benchmark's harness (``portbench/run.py``) with the given
arguments, from the root of the repo, with ``TorchMapperEngine._phase``
wrapped: at each phase's edges the card is synchronised and
``torch.cuda.max_memory_allocated`` is read into the phase that closes
(``between`` for what runs outside every phase, ``after`` for the rest of
the run) and reset. Prints one JSON line, the peak MiB of each phase over
the run. The resets and the synchronise at every edge change the run's own
numbers (``peak_device_gib`` among them), so read only this line:

    python -m metamaps_tpu_torch.profiling.phase_peaks \\
        --workload zymo.ont_minknow4k --seed 1 --seconds 10 --trace 0
"""
from __future__ import annotations

import contextlib
import json
import sys

import torch

from ..engine.mapper_torch import TorchMapperEngine


@contextlib.contextmanager
def phase_peaks():
    """Within the block, every engine's phases record their peak device
    memory, in bytes, into the yielded dict (by phase key)."""
    peaks: dict = {}

    def note(key):
        torch.cuda.synchronize()
        peaks[key] = max(peaks.get(key, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    plain = TorchMapperEngine._phase

    @contextlib.contextmanager
    def phase(self, key):
        note("between")
        with plain(self, key):
            yield
        note(key)

    TorchMapperEngine._phase = phase
    try:
        yield peaks
        note("after")
    finally:
        TorchMapperEngine._phase = plain


def main(argv=None) -> int:
    from portbench import run

    with phase_peaks() as peaks:
        rc = run.run(sys.argv[1:] if argv is None else argv)
    print(json.dumps({k: round(v / 2**20, 1) for k, v in peaks.items()}),
          flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
