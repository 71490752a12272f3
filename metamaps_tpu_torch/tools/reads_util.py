"""Small read-file utilities: util/extractReads.pl and
firstQuartileScore.pl equivalents.

Counterpart: ``metamaps_tpu/tools/reads_util.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Iterable, Set

from ..io.fasta import read_sequences


def reads_for_taxon(r2t_file: str, taxonomy, target: str) -> Set[str]:
    """Read IDs assigned to ``target`` or its subtree in a reads2Taxon file
    (util/extractReads.pl:45-66; target '0' selects only unassigned)."""
    nodes = {target}
    if target != "0" and taxonomy.know_node(target):
        nodes.update(taxonomy.descendants(target))
    out: Set[str] = set()
    with open(r2t_file) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) != 2:
                raise RuntimeError(f"bad reads2Taxon line: {line!r}")
            if fields[1] in nodes:
                out.add(fields[0])
    return out


def extract_reads(reads_file: str, read_ids: Iterable[str], output_fn: str,
                  mode: str = "records"):
    """Extract the named reads (util/extractReads.pl). Modes:

    - ``records`` (default): FASTQ input copies full 4-line records
      (:96-98); FASTA input copies FASTA records.
    - ``sortedFasta``: FASTA output sorted by decreasing length (:104-110).
    - ``lengthDistribution``: write ``readID\\tlength`` lines (:89-93).
    """
    wanted: Set[str] = set(read_ids)
    n = 0
    with open(reads_file) as probe:
        first = probe.read(1)
    is_fastq = first == "@"

    def records():
        if is_fastq:
            with open(reads_file) as f:
                while True:
                    header = f.readline()
                    if not header:
                        break
                    if not header.strip():
                        continue
                    if not header.startswith("@"):
                        raise RuntimeError("corrupted FASTQ: bad header")
                    seq, plus, qual = f.readline(), f.readline(), f.readline()
                    if not plus.startswith("+"):
                        raise RuntimeError("corrupted FASTQ: bad + line")
                    name = header[1:].split()[0]
                    yield name, header, seq, plus, qual
        else:
            for name, seq in read_sequences(reads_file):
                s = seq.tobytes().decode() + "\n"
                yield name, f">{name}\n", s, None, None

    if mode == "sortedFasta":
        kept = {}
        for name, _h, seq, _p, _q in records():
            if name in wanted:
                kept[name] = seq.rstrip("\n")
        with open(output_fn, "w") as out:
            for name in sorted(kept, key=lambda r: -len(kept[r])):
                out.write(f">{name}\n{kept[name]}\n")
        return len(kept)

    with open(output_fn, "w") as out:
        for name, header, seq, plus, qual in records():
            if name not in wanted:
                continue
            n += 1
            if mode == "lengthDistribution":
                out.write(f"{name}\t{len(seq.rstrip())}\n")
            elif plus is None:
                out.write(header + seq)
            else:
                out.write(header + seq + plus + qual)
    return n


def first_quartile_quality(fastq: str):
    """First-quartile base-quality score of a FASTQ file
    (firstQuartileScore.pl): the smallest quality character q such that at
    least 25% of all base qualities are <= q. Returns (char, phred)."""
    counts = {}
    total = 0
    with open(fastq) as f:
        while True:
            header = f.readline()
            if not header:
                break
            if not header.strip():
                continue
            assert header.startswith("@"), header[:30]
            f.readline()
            plus = f.readline()
            assert plus.startswith("+")
            qual = f.readline().rstrip("\n")
            for c in qual:
                counts[c] = counts.get(c, 0) + 1
                total += 1
    running = 0
    for c in sorted(counts):
        running += counts[c] / total
        if running >= 0.25:
            return c, ord(c) - 33
    raise RuntimeError("empty FASTQ")
