"""Each cell's comparison fails what it must fail, at a size a test run
holds: the control (the reference in the program's place, with its
identity arithmetic in bfloat16) reads above the limit it is held to, and
a run with the timed path broken underneath comes out not correct.

The controls at the cells' own sizes run on the card:
``python3 -m portbench.control --workload <cell> --seeds a b c``.
"""
from __future__ import annotations

import pytest

from portbench import core
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny") / "root")


def _limits(root, cell):
    return core.resolve(root, cell).traffic["limits"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mapping_control_fails(root, tmp_path, seed):
    ctx = tiny.context(root, "zymo.ont_files", seed, tmp_path)
    driver = core.load_piece(root, "drivers", "files")
    readings = driver.control(ctx, core.load_piece(root, "setups", "zymo"))
    limits = _limits(root, "zymo.ont_files")
    assert any(v > limits[name] for name, v in readings), readings


def _drop_half(real):
    """Half of the batch left out: every other read gets no lines."""
    def map_reads(self, seqs):
        out = real(self, seqs)
        return [m if i % 2 == 0 else [] for i, m in enumerate(out)]
    return map_reads


def _alter(real):
    """An answer altered where it is produced: each read's first mapping
    one base off."""
    def map_reads(self, seqs):
        out = real(self, seqs)
        for maps in out:
            if maps:
                maps[0].ref_start += 1
        return out
    return map_reads


@pytest.mark.parametrize("cell", ["zymo.ont_files", "zymo.ont_minknow4k"])
@pytest.mark.parametrize("fault", [_drop_half, _alter])
def test_mapping_faults_come_out_not_correct(root, monkeypatch, fault, cell):
    from metamaps_tpu_torch.engine.mapper_torch import TorchMapperEngine

    monkeypatch.setattr(TorchMapperEngine, "map_reads",
                        fault(TorchMapperEngine.map_reads))
    rc, last, _ = tiny.run_cell(root, cell, seed=99)
    assert rc == 0 and last["correct"] is False
