"""``metamaps_tpu_torch/profiling/map_against_index_1g.py`` at a small size
on the CPU: ``index`` + ``mapAgainstIndex`` on the bench's reads write the
bytes of ``mapDirectly`` on the same inputs, and the run writes nothing
outside its work directory. 15 Mbp of the bench's database, where no read
goes to the serial oracle (``tests/test_torch_bench.py``)."""
import json
import os

import pytest
import torch

from metamaps_tpu_torch.profiling import map_against_index_1g as mai

from util_torch import one_torch_thread  # noqa: F401  (autouse fixture)

BASES = 15_000_000


def test_stored_index_maps_as_map_directly(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    work = tmp_path / "work"
    assert mai.main(["--bases", str(BASES), "--reads", "16", "--device",
                     "cpu", "--workdir", str(work)]) == 0
    assert os.listdir(tmp_path) == ["work"]
    with open(work / "record.json") as f:
        rec = json.load(f)
    assert rec["byte_equal"] == {"mappings": True, ".meta": True,
                                 ".meta.unmappedReadsLengths": True}
    for suffix in mai.OUTPUTS:
        with open(work / f"out_ai{suffix}", "rb") as a, \
                open(work / f"out_d{suffix}", "rb") as b:
            assert a.read() == b.read(), suffix
    assert rec["mapping_lines"] > 0
    assert rec["mapAgainstIndex_engine"]["reads_mapped"] == 16
    assert rec["mapDirectly_engine"]["reads_mapped"] == 16
    assert rec["card"] is None and rec["device"] == "cpu"


def test_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mai.main(["--bases", "1000000", "--workdir", str(tmp_path)])
