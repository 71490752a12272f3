"""One ``--maxmemory`` shard of MetaMaps' miniSeq+H database, as a lab
that checks its pipeline on the ZymoBIOMICS D6300 standard maps against
it: the ten D6300 species as clusters of strains, and other species'
clusters filling the shard to ``shard_bases``.

``buildDB.pl`` shuffles the contigs before ``DB.fa`` is split into shards,
so a shard is a random draw of whole genomes: it holds its share of every
species' strains, and a read meets each strain of its species. A species
is a backbone of independent bases at its GC share; each strain of it
takes point substitutions at 1 - ANI on the bases it shares with the
backbone, small indels at ``indel_per_substitution`` of that rate, and
``accessory_share`` of its length replaced by segments of its own. Reads
come from the first strain of each D6300 species alone, at its stated
share of DNA.

Two streams of ``db_seed`` make it: one lays the shard out (clusters,
lengths, GC, ANI), so :func:`read_shares` needs no bases, and one draws
the bases, as bytes in blocks (a float a base would take 8 GB at 1 Gbp).

A read here has about eight candidate regions, and the reference scored
each state of each region's super-window one at a time: a run's check of
449 reads took 412 s on the card's host. :func:`genomes` therefore hands
the reference :mod:`portbench.reference.l2_states`, which gives the same
numbers from one table per region (``portbench/tests/test_miniseqh.py``
holds the two equal on every region of a tiny shard).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from portbench.reference import l2_states, mapping

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.zeros(256, np.int64)
_CODE[_BASES] = np.arange(4)
_BLOCK = 1 << 24  # bases drawn at a time
ACCESSORY, INSERTED = -1, -2  # the kinds of a strain's bases of its own


class Genome(NamedTuple):
    """One contig of the shard as laid out: strain ``strain`` of cluster
    ``cluster``, whose backbone has ``length`` bases at GC share ``gc``."""

    name: str
    cluster: int
    strain: int
    length: int
    gc: float
    ani: float
    share: float  # of the reads


def layout(cfg: dict) -> List[Genome]:
    """The shard's contigs in order: each D6300 species' strains, then
    background clusters until the backbones' bases reach
    ``shard_bases``."""
    rng = np.random.default_rng(np.random.SeedSequence(cfg["db_seed"]).spawn(2)[0])
    st, bg = cfg["strain"], cfg["background"]
    out: List[Genome] = []

    def ani():
        return float(rng.uniform(st["ani_min"], st["ani_max"]))

    for c, sp in enumerate(cfg["species"]):
        n = int(round(float(sp["mbp"]) * 1e6))
        for j in range(int(sp["strains"])):
            out.append(Genome(
                f"{sp['name']}.s{j}|kraken:taxid|{sp['taxid']}|M{len(out)}.1",
                c, j, n, float(sp["gc"]), ani(),
                float(sp["dna_share"]) if j == 0 else 0.0))
    sizes = np.arange(1, int(bg["cluster_max"]) + 1)
    p_size = sizes ** -float(bg["cluster_zipf"])
    p_size /= p_size.sum()
    sigma = float(bg["sigma"])
    mu = np.log(float(bg["mean_mbp"]) * 1e6) - sigma ** 2 / 2
    total = sum(g.length for g in out)
    c = len(cfg["species"])
    while total < int(cfg["shard_bases"]):
        size = int(rng.choice(sizes, p=p_size))
        n = max(1, int(rng.lognormal(mu, sigma)))
        gc = float(rng.uniform(bg["gc_min"], bg["gc_max"]))
        for j in range(size):
            if total >= int(cfg["shard_bases"]):
                break
            out.append(Genome(f"background{c}.s{j}|M{len(out)}.1", c, j, n,
                              gc, ani(), 0.0))
            total += n
        c += 1
    return out


def random_bases(rng, n: int, gc: float) -> np.ndarray:
    """``n`` independent bases at GC share ``gc`` (to 1/256), drawn as
    bytes in blocks."""
    n_gc = int(round(gc * 256))
    table = np.repeat(_BASES[[1, 2, 0, 3]], [n_gc // 2, n_gc - n_gc // 2,
                                             (256 - n_gc) // 2,
                                             256 - n_gc - (256 - n_gc) // 2])
    out = np.empty(n, np.uint8)
    for a in range(0, n, _BLOCK):
        b = min(a + _BLOCK, n)
        out[a:b] = table[np.frombuffer(rng.bytes(b - a), np.uint8)]
    return out


class Edits(NamedTuple):
    """What turns a backbone of ``n`` bases into one strain: disjoint events
    at backbone positions ``pos`` in ascending order, each deleting
    ``d_len`` bases and putting ``i_len`` bases of ``new`` in their place
    (an accessory segment replaces as many bases as it deletes; a small
    indel does one or the other), and substitutions at backbone positions
    ``sub_at`` that no event deletes, each ``sub_shift`` steps on in ACGT."""

    n: int
    pos: np.ndarray
    d_len: np.ndarray
    i_len: np.ndarray
    kind: np.ndarray  # ACCESSORY or INSERTED
    new: np.ndarray
    sub_at: np.ndarray
    sub_shift: np.ndarray

    def alive(self) -> np.ndarray:
        """Whether each backbone base is kept."""
        runs = np.empty(2 * self.pos.size + 1, np.int64)
        runs[0:-1:2] = self.pos - np.concatenate([[0], (self.pos + self.d_len)[:-1]])
        runs[1::2] = self.d_len
        runs[-1] = self.n - (self.pos[-1] + self.d_len[-1] if self.pos.size else 0)
        return np.repeat(np.arange(runs.size) % 2 == 0, runs)

    def insert_at(self) -> np.ndarray:
        """Where each event's bases go among the kept bases."""
        return np.repeat(self.pos - (np.cumsum(self.d_len) - self.d_len), self.i_len)


def edits(rng, n: int, ani: float, gc: float, st: dict) -> Edits:
    """A strain's :class:`Edits` at identity ``ani`` to its backbone:
    accessory segments of ``accessory_min_bp``-``accessory_max_bp`` bases
    up to ``accessory_share`` of ``n``, 1-``indel_max_bp`` bp indels
    outside them at ``indel_per_substitution`` times 1 - ``ani`` a base,
    then substitutions on 1 - ``ani`` of the kept bases (rounded)."""
    lo, hi = int(st["accessory_min_bp"]), int(st["accessory_max_bp"])
    target = int(round(float(st["accessory_share"]) * n))
    acc = []
    while target - sum(acc) >= hi:
        acc.append(int(rng.integers(lo, hi + 1)))
    rest = target - sum(acc)
    if rest >= lo // 2:
        acc.append(min(max(rest, lo), hi))
    acc = np.array(acc, np.int64)
    cuts = np.sort(rng.integers(0, n - int(acc.sum()) + 1, acc.size))
    acc_pos = cuts + np.concatenate([[0], np.cumsum(acc)[:-1]]).astype(np.int64)
    k = int(rng.binomial(n, (1.0 - ani) * float(st["indel_per_substitution"])))
    pos = rng.integers(0, n, k)
    size = rng.integers(1, int(st["indel_max_bp"]) + 1, k)
    is_del = rng.random(k) < 0.5
    d_len = np.where(is_del, size, 0)
    # indels lie outside the accessory segments
    a = np.searchsorted(acc_pos, pos, side="right")
    clear = ((pos >= np.concatenate([[0], acc_pos + acc])[a])
             & (pos + d_len <= np.concatenate([acc_pos, [n]])[a]))
    pos, d_len, size, is_del = pos[clear], d_len[clear], size[clear], is_del[clear]
    # every event in position order, accessory first at a tie; an indel
    # that overlaps one before it goes
    pos = np.concatenate([acc_pos, pos])
    d_len = np.concatenate([acc, d_len])
    i_len = np.concatenate([acc, np.where(is_del, 0, size)])
    kind = np.concatenate([np.full(acc.size, ACCESSORY), np.full(pos.size - acc.size, INSERTED)])
    order = np.argsort(pos, kind="stable")
    pos, d_len, i_len, kind = pos[order], d_len[order], i_len[order], kind[order]
    end = pos + d_len
    ok = pos >= np.concatenate([[0], np.maximum.accumulate(end)[:-1]])
    pos, d_len, i_len, kind = pos[ok], d_len[ok], i_len[ok], kind[ok]
    e = Edits(n, pos, d_len, i_len, kind, random_bases(rng, int(i_len.sum()), gc),
              np.zeros(0, np.int64), np.zeros(0, np.int64))
    alive = e.alive()
    need = int(round((1.0 - ani) * int(alive.sum())))
    at = np.zeros(0, np.int64)
    while at.size < need:
        draw = rng.integers(0, n, int(1.25 * (need - at.size)) + 64)
        at = np.concatenate([at, draw[alive[draw]]])
        _, first = np.unique(at, return_index=True)
        at = at[np.sort(first)]
    return e._replace(sub_at=at[:need], sub_shift=rng.integers(1, 4, need))


def apply(backbone: np.ndarray, e: Edits) -> np.ndarray:
    """The strain's bases."""
    bb = backbone.copy()
    bb[e.sub_at] = _BASES[(_CODE[bb[e.sub_at]] + e.sub_shift) % 4]
    return np.insert(bb[e.alive()], e.insert_at(), e.new)


def genomes(cfg: dict):
    """(genomes, contig names) in :func:`layout`'s order. The reference
    maps them with :func:`l2_states.l2_best` from here on."""
    mapping.l2_best = l2_states.l2_best
    rng = np.random.default_rng(np.random.SeedSequence(cfg["db_seed"]).spawn(2)[1])
    seqs, names = [], []
    backbone, cluster = None, None
    for g in layout(cfg):
        if g.cluster != cluster:
            backbone, cluster = random_bases(rng, g.length, g.gc), g.cluster
        seqs.append(apply(backbone, edits(rng, g.length, g.ani, g.gc,
                                          cfg["strain"])))
        names.append(g.name)
    return seqs, names


def read_shares(cfg: dict) -> np.ndarray:
    """Each contig's share of the reads: a D6300 species' ``dna_share`` on
    its first strain, 0 on every other contig."""
    share = np.array([g.share for g in layout(cfg)])
    return share / share.sum()
