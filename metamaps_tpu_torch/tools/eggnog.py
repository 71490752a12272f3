"""Fan-out helper for protein functional annotation with eggNOG-mapper
(util/splitEggNog.pl equivalent).

``split`` cuts a protein FASTA into ~record-aligned chunks of a target size
(:31-87), ``submit`` writes one runnable shell script per chunk (:88-123;
the annotation command is a template — no scheduler is assumed), and
``collect`` merges the per-chunk ``*.emapper.annotations`` outputs into the
``DB_proteins.faa.annotated`` table consumed by the gene-level analysis
(:125-180): columns ProteinID, GO_terms, KEGG_KOs, BiGG_reactions, OGs,
COG_cat.

Counterpart: ``metamaps_tpu/tools/eggnog.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional

DEFAULT_TARGET_CHARS = 100_000_000

# emapper.py -i {input} --output {output} … ; {input}/{output} substituted
DEFAULT_CMD = "emapper.py -i {input} --output {output} -m diamond --cpu 8"

_COLUMNS = ["ProteinID", "GO_terms", "KEGG_KOs", "BiGG_reactions", "OGs", "COG_cat"]
_EMAPPER_FIELDS = ["#query_name", "GO_terms", "KEGG_KOs", "BiGG_reactions", "OGs", "COG cat"]


def _split_prefix(output: str) -> str:
    return output + ".split"


def split_fasta(input_fasta: str, output: str,
                target_chars: int = DEFAULT_TARGET_CHARS) -> int:
    """Cut the FASTA into chunks of ~target_chars, never splitting a
    record; writes <output>.split.i.<N> files and a .split.done flag."""
    prefix = _split_prefix(output)
    flag = prefix + ".done"
    if os.path.exists(flag):
        raise RuntimeError(f"Input file split already? (flag file {flag} present)")
    existing = glob.glob(prefix + ".i.*")
    if existing:
        raise RuntimeError(f"stale split files present: {existing[:3]}")

    split_i = 0
    running = 0
    out = None

    def open_next():
        nonlocal split_i, out, running
        if out:
            out.close()
        split_i += 1
        out = open(f"{prefix}.i.{split_i}", "w")
        running = 0

    open_next()
    with open(input_fasta) as f:
        for line in f:
            if not line.strip():
                continue
            if line.startswith(">") and running >= target_chars:
                open_next()
            out.write(line)
            running += len(line)
    out.close()
    with open(flag, "w") as f:
        f.write("1")
    return split_i


def write_submit_scripts(output: str, cmd_template: str = DEFAULT_CMD) -> List[str]:
    """One runnable shell script per chunk; each touches a .done flag on
    success. Returns the script paths (the caller dispatches them)."""
    prefix = _split_prefix(output)
    if not os.path.exists(prefix + ".done"):
        raise RuntimeError(f"Input file not split yet? (missing flag {prefix}.done)")
    scripts = []
    for split_file in sorted(glob.glob(prefix + ".i.*")):
        n = split_file.rsplit(".", 1)[1]
        out_file = f"{prefix}.o.{n}"
        ok_flag = out_file + ".done"
        if os.path.exists(ok_flag):
            os.unlink(ok_flag)
        cmd = cmd_template.format(input=split_file, output=out_file)
        script = f"{prefix}.submit.{n}"
        with open(script, "w") as f:
            f.write("#!/bin/bash\n")
            f.write(f"{cmd} && echo 1 > {ok_flag}\n")
        os.chmod(script, 0o755)
        scripts.append(script)
    return scripts


def collect(output: str, annotations_out: Optional[str] = None) -> str:
    """Merge per-chunk emapper annotation tables (3 comment lines, then a
    header naming #query_name/GO_terms/…) into one table."""
    prefix = _split_prefix(output)
    if not os.path.exists(prefix + ".done"):
        raise RuntimeError(f"Input file not split? (missing flag {prefix}.done)")
    if annotations_out is None:
        annotations_out = output
    chunk_tables = []
    for split_file in sorted(glob.glob(prefix + ".i.*")):
        n = split_file.rsplit(".", 1)[1]
        ann = f"{prefix}.o.{n}.emapper.annotations"
        if not os.path.exists(ann):
            raise RuntimeError(f"File {ann} not present")
        chunk_tables.append(ann)

    with open(annotations_out, "w") as out:
        out.write("\t".join(_COLUMNS) + "\n")
        for ann in chunk_tables:
            with open(ann) as f:
                for _ in range(3):
                    f.readline()
                header = f.readline().rstrip("\n").split("\t")
                col_idx = {}
                for field in _EMAPPER_FIELDS:
                    if field not in header:
                        raise RuntimeError(f"missing column {field!r} in {ann}")
                    col_idx[field] = header.index(field)
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#"):
                        continue
                    fields = line.split("\t")
                    out.write(
                        "\t".join(fields[col_idx[c]] for c in _EMAPPER_FIELDS)
                        + "\n"
                    )
    return annotations_out
