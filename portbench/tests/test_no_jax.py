"""No run of the benchmark loads JAX or the JAX package, and none opens the
repository's own JAX-era benchmark files (the root ``profiling/``,
``bench.py``, ``.bench_cache/``): a whole run on the CPU in a fresh
process with those modules blocked, compared by whole top-level name (so
``metamaps_tpu_torch`` is not caught), and every opened path recorded."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from portbench.tests import tiny

SCRIPT = textwrap.dedent("""
    import json, os, sys
    BLOCKED = ("jax", "jaxlib", "flax", "metamaps_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".", 1)[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    opened = []
    sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                     if ev == "open" and args and isinstance(args[0], str)
                     else None)
    sys.path.insert(0, sys.argv[1])
    from portbench.tests import tiny
    rc, last, _ = tiny.run_cell(sys.argv[2], sys.argv[3], 1234567891011, 1)
    loaded = [m for m in sys.modules if m.split(".", 1)[0] in BLOCKED]
    print(json.dumps({"rc": rc, "correct": last and last["correct"],
                      "loaded": loaded, "opened": opened}))
""")


@pytest.mark.parametrize("cell", ["zymo.ont_files", "zymo.ont_minknow4k"])
def test_a_run_loads_no_jax_and_reads_no_jax_benchmark(tmp_path, cell):
    root = tiny.tiny_root(tmp_path / "root")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tiny.ROOT),
                          str(root), cell], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["correct"] is True
    assert res["loaded"] == []
    for top in ("profiling", "bench.py", ".bench_cache"):
        for r in (tiny.ROOT, root):
            bad = [p for p in res["opened"] if p.startswith(str(r / top))]
            assert not bad, bad


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from portbench import core

    monkeypatch.setitem(sys.modules, "metamaps_tpu_torch_fake", object())
    assert "metamaps_tpu_torch_fake" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in core.forbidden_loaded()
