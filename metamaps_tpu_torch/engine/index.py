"""Reference minimizer index: build, memory-bounded sharding, serialization.

Counterpart: ``metamaps_tpu/engine/index.py``, of which this is a jax-free
copy (the JAX package's module imports ``jax`` through its winnowing
module). It reads and writes the same ``.npz`` shard files.

TPU-first re-design of the reference's skch::Sketch
(src/map/include/winSketch.hpp):

- the hash table ``unordered_map<hash, vector<pos>>`` becomes sorted flat
  arrays: hashes sorted ascending with the (seqId, wpos, strand) payloads
  gathered alongside — L1 lookup is a vectorized binary search, frequency
  filtering a count comparison;
- the position-ordered ``minimizerIndex`` stays a flat (seqId, wpos)-sorted
  array with per-contig offsets for L2 range scans;
- the memory-bounded shard cut (winSketch.hpp:298-329) is reproduced with
  the reference's exact memory model (winSketch.hpp:165-178) so shard
  boundaries — and therefore shard-local sequence ids — match;
- the frequency threshold replicates computeFreqHist (winSketch.hpp:452-495).

Serialization is npz + a manifest (the reference's boost archives become
flat arrays; the ``<prefix>.index`` completeness sentinel is kept).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np

from metamaps_tpu_torch.io.fasta import read_sequences

from ..ops.winnow import winnow_fast

INT_MAX = 2**31 - 1


def reference_memory_model(hashes: int, minimizers: int) -> int:
    """The reference's per-shard memory estimate (winSketch.hpp:165-178),
    reproduced exactly (integer bucket division, 1.2 fudge factor via double,
    x86-64 type sizes)."""
    estimated_buckets = hashes // 10
    memory_hash_table = (
        estimated_buckets * (8 + 8)  # bucket pointers
        + hashes * 8  # bucket chain links
        + hashes * 24  # vector headers
        + minimizers * 12  # MinimizerMetaData payloads
    )
    memory_hash_table = int(memory_hash_table * 1.2)
    memory_vector = 24 + minimizers * 16  # MI_Type + MinimizerInfo
    return memory_hash_table + memory_vector


@dataclass
class SketchShard:
    """One self-contained index shard (maps every read independently)."""

    # contig metadata — ALL contigs seen while this shard was current,
    # including too-short ones (reference keeps them in `metadata`)
    contig_names: List[str] = field(default_factory=list)
    contig_lengths: List[int] = field(default_factory=list)

    # position-ordered minimizer arrays (seqId asc, wpos asc)
    seqid: np.ndarray = None  # int32
    wpos: np.ndarray = None  # int32
    strand: np.ndarray = None  # int8
    hash_pos_order: np.ndarray = None  # uint32, aligned with the above

    # hash-ordered view for L1 lookup
    hash_sorted: np.ndarray = None  # uint32 ascending
    seqid_byhash: np.ndarray = None
    wpos_byhash: np.ndarray = None
    strand_byhash: np.ndarray = None

    contig_offsets: np.ndarray = None  # int64 [n_contigs+1] into position order
    freq_threshold: int = INT_MAX

    # position->hash-order permutation from finalize's argsort (int32; not
    # serialized — restored shards fall back to searchsorted). Kept because
    # DeviceShard.host_tables needs each minimizer's first hash-ordered row
    # (hrow): with the permutation that is an O(M) scatter instead of an
    # O(M log M) random-access binary search — at 10^8 minimizers the
    # dominant host-build stage (measured: 8.6 s vs ~0.3 s per 10^7).
    hash_order: np.ndarray = None

    def finalize(self, parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]):
        """parts: list of (hashes, wpos, strand, seqid) per contig, in order."""
        if parts:
            self.hash_pos_order = np.concatenate([p[0] for p in parts]).astype(np.uint32)
            self.wpos = np.concatenate([p[1] for p in parts]).astype(np.int32)
            self.strand = np.concatenate([p[2] for p in parts]).astype(np.int8)
            self.seqid = np.concatenate(
                [np.full(len(p[0]), p[3], np.int32) for p in parts]
            )
        else:
            self.hash_pos_order = np.zeros(0, np.uint32)
            self.wpos = np.zeros(0, np.int32)
            self.strand = np.zeros(0, np.int8)
            self.seqid = np.zeros(0, np.int32)

        order = np.argsort(self.hash_pos_order, kind="stable")
        self.hash_sorted = self.hash_pos_order[order]
        self.seqid_byhash = self.seqid[order]
        self.wpos_byhash = self.wpos[order]
        self.strand_byhash = self.strand[order]
        self.hash_order = (
            order.astype(np.int32) if order.size < 2**31 else order
        )

        n_contigs = len(self.contig_names)
        self.contig_offsets = np.searchsorted(
            self.seqid, np.arange(n_contigs + 1), side="left"
        ).astype(np.int64)

        self._compute_freq_threshold()
        return self

    def _compute_freq_threshold(self):
        """computeFreqHist parity (winSketch.hpp:452-495)."""
        self.freq_threshold = INT_MAX
        if self.hash_sorted.size == 0:
            return
        # hash_sorted is ascending, so uniques are run boundaries — O(M)
        # passes instead of np.unique's full re-sort (seconds per 10^7)
        hs = self.hash_sorted
        new_run = np.empty(hs.size, np.bool_)
        new_run[0] = True
        np.not_equal(hs[1:], hs[:-1], out=new_run[1:])
        starts = np.flatnonzero(new_run)
        counts = np.diff(np.append(starts, hs.size))
        total_unique = counts.size
        to_ignore = int(total_unique * 0.001 / 100)
        hist_full = np.bincount(counts)
        hist_counts = np.flatnonzero(hist_full)  # ascending
        hist_n = hist_full[hist_counts]
        s = 0
        for c, n in zip(hist_counts[::-1], hist_n[::-1]):
            s += int(n)
            if s < to_ignore:
                self.freq_threshold = int(c)
            elif s == to_ignore:
                self.freq_threshold = int(c)
                break
            else:
                break

    # --- queries ------------------------------------------------------------

    def ensure_hash_order_views(self):
        """Derive the hash-ordered view arrays when a loader skipped them.

        The bench's v5 disk cache omits the hash-order argsort at load (at
        3.3 Gbp/shard it is ~45 s per swap) because these views only serve
        the serial-oracle fallback, which the tuned device ladders make
        rare (0 fallbacks in every recorded bench). The fallback paths call
        this lazily; it is a no-op when the views already exist."""
        if self.hash_sorted is not None and self.strand_byhash is not None:
            return
        order = np.argsort(self.hash_pos_order, kind="stable")
        self.hash_sorted = self.hash_pos_order[order]
        if self.seqid_byhash is None:
            self.seqid_byhash = self.seqid[order]
        if self.wpos_byhash is None:
            self.wpos_byhash = self.wpos[order]
        self.strand_byhash = self.strand[order]

    def lookup_counts(self, hashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(start, count) ranges in the hash-ordered arrays per query hash."""
        self.ensure_hash_order_views()
        start = np.searchsorted(self.hash_sorted, hashes, side="left")
        end = np.searchsorted(self.hash_sorted, hashes, side="right")
        return start.astype(np.int64), (end - start).astype(np.int64)

    def search_index(self, seq_id: int, winpos: int) -> int:
        """lower_bound over (seqId, wpos) in position order
        (winSketch.hpp:506-517). Returns an index into the position-ordered
        arrays (may be outside the contig's own range, as in the reference).
        The packed key array is built once per shard — at 10^8 minimizers a
        per-call rebuild made every oracle fallback O(M)."""
        keys = getattr(self, "_pos_keys", None)
        if keys is None or keys.size != self.seqid.size:
            keys = (self.seqid.astype(np.int64) << 32) | self.wpos.astype(
                np.int64
            )
            self._pos_keys = keys
        key = np.int64(seq_id) << 32 | np.int64(max(0, winpos))
        return int(np.searchsorted(keys, key, side="left"))

    @property
    def n_minimizers(self) -> int:
        return int(self.hash_pos_order.size)

    # --- serialization ------------------------------------------------------

    def save(self, path: str):
        np.savez_compressed(
            path,
            contig_names=np.array(self.contig_names, dtype=object),
            contig_lengths=np.array(self.contig_lengths, dtype=np.int64),
            seqid=self.seqid,
            wpos=self.wpos,
            strand=self.strand,
            hash_pos_order=self.hash_pos_order,
            freq_threshold=np.int64(self.freq_threshold),
            allow_pickle=True,
        )

    @classmethod
    def load(cls, path: str) -> "SketchShard":
        z = np.load(path, allow_pickle=True)
        shard = cls(
            contig_names=[str(x) for x in z["contig_names"]],
            contig_lengths=[int(x) for x in z["contig_lengths"]],
        )
        shard.seqid = z["seqid"]
        shard.wpos = z["wpos"]
        shard.strand = z["strand"]
        shard.hash_pos_order = z["hash_pos_order"]
        order = np.argsort(shard.hash_pos_order, kind="stable")
        shard.hash_sorted = shard.hash_pos_order[order]
        shard.seqid_byhash = shard.seqid[order]
        shard.wpos_byhash = shard.wpos[order]
        shard.strand_byhash = shard.strand[order]
        n_contigs = len(shard.contig_names)
        shard.contig_offsets = np.searchsorted(
            shard.seqid, np.arange(n_contigs + 1), side="left"
        ).astype(np.int64)
        shard.freq_threshold = int(z["freq_threshold"])
        return shard


def _iter_winnowed(files, k, w, a, winnow_fn, threads):
    """Yield (name, seq, (h, p, s) or None-for-too-short) per contig in file
    order. With threads > 1, winnowing runs on a thread pool with a bounded
    in-flight window (the native winnower releases the GIL) while the
    consumer still sees strict file order — the shard-cut semantics stay
    identical to the serial loop."""
    def gen():
        for file_name in files:
            for name, seq in read_sequences(file_name):
                yield name, seq

    if threads <= 1:
        for name, seq in gen():
            hps = winnow_fn(seq, k, w, a) if len(seq) >= max(w, k) else None
            yield name, seq, hps
        return

    from concurrent.futures import ThreadPoolExecutor
    from collections import deque

    with ThreadPoolExecutor(max_workers=threads) as pool:
        pending = deque()
        it = gen()
        done = False
        while True:
            while not done and len(pending) < 2 * threads:
                try:
                    name, seq = next(it)
                except StopIteration:
                    done = True
                    break
                if len(seq) >= max(w, k):
                    fut = pool.submit(winnow_fn, seq, k, w, a)
                else:
                    fut = None
                pending.append((name, seq, fut))
            if not pending:
                break
            name, seq, fut = pending.popleft()
            yield name, seq, fut.result() if fut is not None else None


def build_shards(
    params,
    maximum_memory: int,
    on_shard: Callable[[SketchShard, int], None],
    winnow_fn=winnow_fast,
):
    """Stream the reference FASTA(s), winnow per contig, cut shards by the
    reference memory model, and invoke ``on_shard(shard, shard_number)`` for
    each completed shard (reference build_and_store_index,
    winSketch.hpp:180-365). Sequence ids are local to each shard.
    ``params.threads`` > 1 parallelizes the per-contig winnowing (the
    reference's pthread pool analog for the build phase)."""
    k, w, a = params.kmer_size, params.window_size, params.alphabet_size

    shard = SketchShard()
    parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = []
    known_hashes: set = set()
    running_hashes = 0
    running_minimizers = 0
    shard_number = 1
    local_seq_counter = 0

    threads = int(getattr(params, "threads", 1) or 1)
    for name, seq, hps in _iter_winnowed(
        params.ref_sequences, k, w, a, winnow_fn, threads
    ):
            if hps is None:
                shard.contig_names.append(name)
                shard.contig_lengths.append(len(seq))
                local_seq_counter += 1
                continue

            h, p, s = hps
            contig_hashes = set(map(int, np.unique(h)))
            would_add_hashes = len(contig_hashes - known_hashes)
            would_add_minimizers = len(h)

            if_total_hashes = running_hashes + would_add_hashes
            if_total_minimizers = running_minimizers + would_add_minimizers
            memory_after = reference_memory_model(if_total_hashes, if_total_minimizers)

            if maximum_memory > 0 and memory_after > maximum_memory:
                shard.finalize(parts)
                _log_shard(shard, shard_number)
                on_shard(shard, shard_number)

                shard = SketchShard()
                parts = []
                known_hashes = set()
                running_hashes = 0
                running_minimizers = 0
                local_seq_counter = 0
                shard_number += 1

                would_add_hashes = len(contig_hashes)
                if_total_hashes = would_add_hashes
                if_total_minimizers = would_add_minimizers
                memory_after = reference_memory_model(
                    if_total_hashes, if_total_minimizers
                )
                if memory_after > maximum_memory:
                    raise RuntimeError(
                        f"contig {name} alone exceeds the memory limit "
                        f"({memory_after} > {maximum_memory} bytes)"
                    )

            parts.append((h, p, s, local_seq_counter))
            shard.contig_names.append(name)
            shard.contig_lengths.append(len(seq))
            known_hashes |= contig_hashes
            running_hashes = if_total_hashes
            running_minimizers = if_total_minimizers
            local_seq_counter += 1

    shard.finalize(parts)
    _log_shard(shard, shard_number)
    on_shard(shard, shard_number)
    return shard_number


def _log_shard(shard: SketchShard, n: int):
    """INFO summary per completed shard (the reference's index-build print,
    winSketch.hpp:362)."""
    import sys

    print(
        f"INFO, metamaps_tpu::index, shard {n}: "
        f"{len(shard.contig_names)} sequences, "
        f"{shard.n_minimizers} minimizers, "
        f"freq_threshold={shard.freq_threshold}",
        file=sys.stderr,
    )


def create_index(params, prefix: str, maximum_memory: int = 0):
    """metamaps index equivalent (mapWrap.h:358-405): persist shards +
    manifest with a build-completeness sentinel."""
    with open(prefix + ".index", "w") as f:
        f.write("0\n")

    from metamaps_tpu_torch.io.mappings import write_parameters_file

    write_parameters_file(prefix, params)

    generated: List[str] = []

    def store(shard: SketchShard, n: int):
        out = f"{prefix}.{n}.npz"
        shard.save(out)
        generated.append(out)

    build_shards(params, maximum_memory, store)

    with open(prefix + ".index", "w") as f:
        f.write("1\n")
        for g in generated:
            f.write(g + "\n")
    return generated


def load_index_manifest(prefix: str) -> List[str]:
    path = prefix + ".index"
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    if not lines or lines[0] != "1":
        raise RuntimeError(f"index {prefix} was not built successfully")
    if len(lines) < 2:
        raise RuntimeError(f"index {prefix} has no shard files")
    return lines[1:]
