"""EM composition estimator and per-read taxonomic assignment.

Counterpart: ``metamaps_tpu/engine/em.py``. The host float64 path and every
output file are copied unchanged; the JAX device round
(``make_em_iterate_jax``) becomes a float64 torch round on an explicit device
(:func:`make_em_iterate_torch`); the ``sharded`` backend runs float64 rounds
data-parallel over a list of devices with the per-read and per-taxon sums
summed over the ranks (``parallel/mesh.py``), and ``auto`` picks the host
below ``EM_AUTO_DEVICE_MIN_LINES`` lines or on the CPU, the device round
above, as the JAX package's rule does.

Parity re-implementation of the reference classifier (src/meta/fEM.h) with a
vectorized E/M-step over flat (read x location) arrays:

- per-location likelihood l = f[taxon] * (1/#possibleStartPositions) * mapQ
  (getMappingLocations, fEM.h:234-373), normalized per read;
- M-step: f' = segment-sum of responsibilities by taxon, normalized;
- convergence when delta-loglik <= 1 AND relative improvement < 1e-4
  (fEM.h:624-656);
- outputs: .EM (recalibrated mappings), .EM.lengthAndIdentitiesPerMappingUnit,
  .EM.reads2Taxon[.krona], .EM.WIMP (producePotFile, fEM.h:52-215),
  .EM.contigCoverage (1000-bp windows, incl. the reference's size_t
  arithmetic on the last window), .EM.evidenceUnknownSpecies
  (fEM.h:846-1132).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np
import torch
from scipy import stats as spstats

from ..device import require_cuda
from ..io.mappings import fmt_g, iter_reads_grouped, read_meta, read_unmapped_lengths
from ..parallel.mesh import make_em_iterate_sharded
from ..taxonomy import RELEVANT_LEVEL_NAMES, Taxonomy, extract_taxon_id

COVERAGE_WINDOW = 1000
_U64 = 2 ** 64


def _to_string(x: float) -> str:
    """C++ std::to_string(double): fixed 6 decimal places."""
    return "%.6f" % x


def load_relevant_taxon_info(db_dir: str, taxon_ids: Set[str]):
    """taxonInfo.txt -> {taxonID: {contigID: length}} (fEM.h:1320-1364)."""
    out: Dict[str, Dict[str, int]] = {}
    fn = os.path.join(db_dir, "taxonInfo.txt")
    with open(fn) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            taxon_id, _, contigs = line.partition(" ")
            d = {}
            for c in contigs.split(";"):
                cid, _, length = c.partition("=")
                d[cid] = int(length)
            out[taxon_id] = d
    return out


def get_ns_per_window(db_dir: str, window_size: int, needed_contigs: Set[str]):
    """contigNstats_windowSize_<n>.txt -> {contigID: [N counts per window]}
    (fEM.h:1421-1473)."""
    out: Dict[str, List[int]] = {}
    fn = os.path.join(db_dir, f"contigNstats_windowSize_{window_size}.txt")
    with open(fn) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            taxon_id, contig_id, fields = line.split("\t")
            if contig_id in needed_contigs:
                out[contig_id] = [int(x) for x in fields.split(";")]
    missing = needed_contigs - set(out)
    if missing:
        raise RuntimeError(f"missing contigNstats entries: {sorted(missing)[:5]}")
    return out


@dataclass
class MappingTable:
    """Flat arrays over all mapping lines, grouped per read (file order)."""

    lines: List[str]  # raw lines (without trailing newline)
    read_of_line: np.ndarray  # int64 [L] read index
    taxon_of_line: np.ndarray  # int32 [L] index into taxon_list
    mapq: np.ndarray  # float64 [L]
    inv_locations: np.ndarray  # float64 [L] 1/#possibleStartPositions
    identity: np.ndarray  # float64 [L] fraction
    contig_of_line: List[str]
    start: np.ndarray  # int64 [L]
    stop: np.ndarray  # int64 [L]
    read_len: np.ndarray  # int64 [L]
    read_ids: List[str]  # [R]
    taxon_list: List[str]  # sorted


def _parse_columns_python(mapped_file: str):
    """Pure-Python fallback for the native parser (same column dict)."""
    lines_all: List[str] = []
    read_of_line: List[int] = []
    contig_map: Dict[str, int] = {}
    contigs: List[str] = []
    contig_idx: List[int] = []
    mapq: List[float] = []
    identity: List[float] = []
    start: List[int] = []
    stop: List[int] = []
    read_len: List[int] = []
    read_ids: List[str] = []

    for ri, read_lines in enumerate(iter_reads_grouped(mapped_file)):
        for line in read_lines:
            f = line.split(" ")
            contig_id = f[5]
            ci = contig_map.get(contig_id)
            if ci is None:
                ci = len(contigs)
                contig_map[contig_id] = ci
                contigs.append(contig_id)
            try:
                q = float(f[13])
            except (ValueError, OverflowError):
                q = 0.0
            lines_all.append(line)
            read_of_line.append(ri)
            contig_idx.append(ci)
            mapq.append(q)
            identity.append(float(f[9]) / 100.0)
            start.append(int(f[7]))
            stop.append(int(f[8]))
            read_len.append(int(f[1]))
        read_ids.append(read_lines[0].split(" ", 1)[0])

    return {
        "lines": lines_all,
        "read_of_line": np.array(read_of_line, np.int64),
        "contig_idx": np.array(contig_idx, np.int32),
        "contigs": contigs,
        "mapq": np.array(mapq, np.float64),
        "identity": np.array(identity, np.float64),
        "start": np.array(start, np.int64),
        "stop": np.array(stop, np.int64),
        "read_len": np.array(read_len, np.int64),
        "read_ids": read_ids,
    }


def load_mapping_table(mapped_file: str, taxon_info) -> MappingTable:
    from ..io.native import parse_mappings_native

    cols = parse_mappings_native(mapped_file)
    if cols is None:
        cols = _parse_columns_python(mapped_file)

    lines_all: List[str] = cols["lines"]
    contigs: List[str] = cols["contigs"]
    contig_idx = np.asarray(cols["contig_idx"], np.int64)
    read_of_line_arr = np.asarray(cols["read_of_line"], np.int64)
    read_len_arr = np.asarray(cols["read_len"], np.int64)
    start_arr = np.asarray(cols["start"], np.int64)
    stop_arr = np.asarray(cols["stop"], np.int64)
    mapq_arr = np.asarray(cols["mapq"], np.float64)
    identity_arr = np.asarray(cols["identity"], np.float64)
    read_ids: List[str] = cols["read_ids"]
    n_lines = len(lines_all)
    n_reads = len(read_ids)

    # taxon resolution + DB membership check, per unique contig only
    taxon_per_contig: List[str] = []
    for c in contigs:
        t = extract_taxon_id(c)
        if t not in taxon_info:
            raise RuntimeError(
                f"Unknown taxonID '{t}' — was this mapped against "
                f"the specified database?"
            )
        taxon_per_contig.append(t)

    read_starts = np.searchsorted(read_of_line_arr, np.arange(n_reads + 1))
    if n_lines:
        # per-line quality range + per-read sum-to-one (fEM.h parity)
        assert float(mapq_arr.min()) >= 0.0 and float(mapq_arr.max()) <= 1.0
        mq_sums = np.add.reduceat(mapq_arr, read_starts[:-1])
        assert float(np.abs(1.0 - mq_sums).max()) <= 1e-3

    taxon_list = sorted(set(taxon_per_contig))
    tmap = {t: i for i, t in enumerate(taxon_list)}
    tax_of_contig = np.array([tmap[t] for t in taxon_per_contig], np.int32)
    taxon_of_line = (
        tax_of_contig[contig_idx] if n_lines else np.empty(0, np.int32)
    )
    contig_idx_list = contig_idx.tolist()
    contig_of_line = [contigs[i] for i in contig_idx_list]

    # 1/#possibleMappingLocations per (read, taxon) (fEM.h:324-348):
    # sum over the taxon's contigs of (len - readLen + 1) for contigs at
    # least read-length long, plus 1 for each shorter contig that appears in
    # this read's own mapping lines. Vectorized over (read, taxon) pairs.
    sorted_lengths = {}
    for i, t in enumerate(taxon_list):
        ls = np.sort(np.array(list(taxon_info[t].values()), np.int64))
        suffix = np.concatenate([np.cumsum(ls[::-1])[::-1], [0]])
        sorted_lengths[i] = (ls, suffix)

    pair_key = read_of_line_arr * np.int64(len(taxon_list)) + taxon_of_line
    pair_unique, pair_inv = np.unique(pair_key, return_inverse=True)
    pair_read = (pair_unique // len(taxon_list)).astype(np.int64)
    pair_tax = (pair_unique % len(taxon_list)).astype(np.int64)
    # read length per read (constant within a read)
    rl_per_read = read_len_arr[read_starts[:-1]]
    pair_rl = rl_per_read[pair_read]

    base = np.zeros(pair_unique.size, np.int64)
    for ti in range(len(taxon_list)):
        sel = np.flatnonzero(pair_tax == ti)
        if not sel.size:
            continue
        ls, suffix = sorted_lengths[ti]
        i0 = np.searchsorted(ls, pair_rl[sel], side="left")
        n_ge = ls.size - i0
        base[sel] = suffix[i0] - n_ge * (pair_rl[sel] - 1)

    # +1 per distinct short contig of this (read, taxon) seen in the lines
    len_of_contig = np.array(
        [taxon_info[taxon_per_contig[u]][contigs[u]] for u in range(len(contigs))],
        np.int64,
    )
    contig_len_line = (
        len_of_contig[contig_idx] if n_lines else np.empty(0, np.int64)
    )
    short_mask = contig_len_line < read_len_arr
    if short_mask.any():
        n_contigs = len(contigs)
        trip = (
            pair_inv[short_mask].astype(np.int64) * n_contigs
            + contig_idx[short_mask]
        )
        trip_unique = np.unique(trip)
        short_counts = np.bincount(
            (trip_unique // n_contigs).astype(np.int64),
            minlength=pair_unique.size,
        )
        base += short_counts
    assert (base > 0).all()

    inv_loc = 1.0 / base[pair_inv].astype(np.float64)

    return MappingTable(
        lines=lines_all,
        read_of_line=read_of_line_arr,
        taxon_of_line=taxon_of_line,
        mapq=mapq_arr,
        inv_locations=inv_loc,
        identity=identity_arr,
        contig_of_line=contig_of_line,
        start=start_arr,
        stop=stop_arr,
        read_len=read_len_arr,
        read_ids=read_ids,
        taxon_list=taxon_list,
    )


def em_iterate(table: MappingTable, f: np.ndarray) -> Tuple[np.ndarray, float]:
    """One EM round: returns (f_next normalized, log-likelihood)."""
    n_reads = len(table.read_ids)
    l = f[table.taxon_of_line] * table.inv_locations * table.mapq
    per_read = np.bincount(table.read_of_line, weights=l, minlength=n_reads)
    assert (per_read > 0).all(), "read with zero total location probability"
    ll = float(np.log(per_read).sum())
    p = l / per_read[table.read_of_line]
    f_next = np.bincount(table.taxon_of_line, weights=p, minlength=f.size)
    f_next /= f_next.sum()
    return f_next, ll


def make_em_iterate_torch(table: MappingTable, device):
    """EM round on ``device`` in float64: the same function as
    :func:`em_iterate`, returning a function f -> (f_next, ll) on host
    numpy / float.

    Counterpart of ``make_em_iterate_jax`` (``metamaps_tpu/engine/em.py``),
    without its blocked chunk scan, which exists only for XLA's compile
    time: the sharded round (``parallel/mesh.py``) over the one rank
    ``device``, whose CSR segment sums give the same bits in every round
    and every run on one card."""
    return make_em_iterate_sharded(table, [device])


EM_BACKENDS = ("torch", "numpy", "sharded", "auto")

#: 'auto' switches to the device backend above this many mapping lines —
#: below it the host float64 bincounts win (and keep exact parity anyway).
EM_AUTO_DEVICE_MIN_LINES = 5_000_000


def _resolve_em_backend(table: MappingTable, backend: str, device="cuda") -> str:
    """``auto`` -> 'numpy' below ``EM_AUTO_DEVICE_MIN_LINES`` lines or when
    ``device`` is the CPU, else 'torch' (``_resolve_em_backend`` of the JAX
    package, with 'torch' for its 'jax'); any other backend is itself."""
    if backend != "auto":
        return backend
    if len(table.lines) < EM_AUTO_DEVICE_MIN_LINES:
        return "numpy"
    if torch.device(device).type == "cpu":
        return "numpy"
    return "torch"


def em_devices(device) -> list:
    """The ranks of the sharded backend: a list of devices as given, every
    visible CUDA device for a CUDA device name (raises without CUDA), one
    rank for the CPU."""
    if isinstance(device, (list, tuple)):
        return list(device)
    if require_cuda(device).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def run_em(table: MappingTable, verbose: bool = True, backend: str = "numpy",
           device="cuda"):
    """The EM loop with the reference convergence rule (fEM.h:501-661).

    backend 'numpy' runs the float64 rounds on the host (parity path);
    'torch' runs them in float64 on ``device`` (:func:`make_em_iterate_torch`)
    with the same host-side convergence control; 'sharded' runs them
    data-parallel over the ranks :func:`em_devices` makes of ``device`` (a
    device name, or a list of devices in which one may repeat); 'auto' picks
    as :func:`_resolve_em_backend` says."""
    if backend not in EM_BACKENDS:
        raise ValueError(f"unknown EM backend {backend!r}; one of {EM_BACKENDS}")
    backend = _resolve_em_backend(table, backend, device)
    n_tax = len(table.taxon_list)
    f = np.full(n_tax, 1.0 / n_tax, np.float64)
    if backend == "torch":
        step = make_em_iterate_torch(table, device)
    elif backend == "sharded":
        step = make_em_iterate_sharded(table, em_devices(device))
    else:
        step = lambda f_in: em_iterate(table, f_in)
    ll_last = None
    iteration = 0
    while True:
        f_next, ll = step(f)
        if verbose:
            print(f"EM round {iteration}\n\tLog likelihood: {ll}")
        if ll_last is not None:
            ll_diff = ll - ll_last
            assert ll_diff >= -1e-6, f"EM log-likelihood decreased by {-ll_diff}"
            rel_imp = 1 - ll / ll_last
            if ll_diff <= 1 and rel_imp < 1e-4:
                f = f_next
                break
        f = f_next
        ll_last = ll
        iteration += 1
    return f, iteration


def responsibilities(table: MappingTable, f: np.ndarray) -> np.ndarray:
    n_reads = len(table.read_ids)
    l = f[table.taxon_of_line] * table.inv_locations * table.mapq
    per_read = np.bincount(table.read_of_line, weights=l, minlength=n_reads)
    return l / per_read[table.read_of_line]


def clean_f(
    f: Dict[str, float], reads_per_taxon: Dict[str, int], distributed_reads: int
):
    """Drop taxa below 0.9/nReads with no assigned reads; renormalize
    (fEM.h:1135-1163)."""
    min_freq = 0.9 * (1.0 / distributed_reads)
    for t in [t for t, v in f.items() if v < min_freq and t not in reads_per_taxon]:
        del f[t]
    s = sum(f.values())
    assert s > 0
    for t in f:
        f[t] /= s


def produce_pot_file(
    out_fn: str,
    taxonomy: Taxonomy,
    frequencies: Dict[str, float],
    read_count: Dict[str, int],
    n_total: int,
    n_unmapped: int,
    n_too_short: int,
):
    """The .EM.WIMP table (producePotFile, fEM.h:52-215)."""
    combined = set(frequencies) | set(read_count)
    target_levels = RELEVANT_LEVEL_NAMES

    f_per_level: Dict[str, Dict[str, float]] = {}
    rc_per_level: Dict[str, Dict[str, int]] = {}
    keys_per_level: Dict[str, Set[str]] = {}

    for node, freq in frequencies.items():
        up = taxonomy.get_upward_by_ranks(node, target_levels)
        up["definedGenomes"] = node
        for level, up_node in up.items():
            f_per_level.setdefault(level, {}).setdefault(up_node, 0.0)
            f_per_level[level][up_node] += freq
            keys_per_level.setdefault(level, set()).add(up_node)

    for node, count in read_count.items():
        up = taxonomy.get_upward_by_ranks(node, target_levels)
        up["definedGenomes"] = node
        for level, up_node in up.items():
            rc_per_level.setdefault(level, {}).setdefault(up_node, 0)
            rc_per_level[level][up_node] += count
            keys_per_level.setdefault(level, set()).add(up_node)

    n_mappable = n_total - n_too_short
    assert n_mappable > 0
    n_mapped = n_mappable - n_unmapped
    assert n_mapped >= 0

    with open(out_fn, "w") as out:
        out.write(
            "AnalysisLevel\ttaxonID\tName\tAbsolute\tEMFrequency\tPotFrequency\n"
        )
        for level in sorted(keys_per_level):  # std::map string order
            keys = sorted(keys_per_level[level])
            fl = f_per_level.setdefault(level, {})
            rl = rc_per_level.setdefault(level, {})
            sum_f = 0.0
            sum_rc = 0
            for t in keys:
                fl.setdefault(t, 0.0)
                rl.setdefault(t, 0)
                sum_f += fl[t]
                sum_rc += rl[t]
            assert abs(1 - sum_f) <= 1e-3
            f_em = {t: fl[t] / sum_f for t in keys}
            assert (n_mappable - sum_rc) == n_unmapped

            prop_mapped = n_mapped / n_mappable
            prop_not_mapped = n_unmapped / n_mappable
            f_pot = {t: f_em[t] * prop_mapped for t in keys}

            em_unmapped = 0.0
            unmapped_und = n_unmapped
            for t in keys:
                if t != "Undefined":
                    name = taxonomy.get_node(t).scientific_name
                    out.write(
                        f"{level}\t{t}\t{name}\t{rl[t]}\t{fmt_g(f_em[t])}\t{fmt_g(f_pot[t])}\n"
                    )
                else:
                    unmapped_und += rl[t]
                    em_unmapped += f_em[t]
                    prop_not_mapped += f_pot[t]
            out.write(
                f"{level}\t0\tUnclassified\t{unmapped_und}\t{fmt_g(em_unmapped)}\t{fmt_g(prop_not_mapped)}\n"
            )
            out.write(f"{level}\t-3\ttotalReads\t{n_total}\t0\t0\n")
            out.write(f"{level}\t-3\treadsLongEnough\t{n_mappable}\t0\t0\n")
            out.write(f"{level}\t-3\treadsLongEnough_unmapped\t{n_unmapped}\t0\t0\n")


def _contig_windows(contig_length: int):
    """Window count and the reference's size_t last-window length
    (fEM.h:730-753, including the unsigned underflow when the length is not
    a multiple of the window size)."""
    n = contig_length // COVERAGE_WINDOW
    if n == 0:
        return 1, contig_length
    if n * COVERAGE_WINDOW != contig_length:
        n += 1
        last = (contig_length - n * COVERAGE_WINDOW) % _U64
    else:
        last = COVERAGE_WINDOW
    return n, last


def _overlap(a_left, a_right, b_left, b_right):
    """Closed-interval overlap (meta/util.h:150-173)."""
    lo = max(a_left, b_left)
    hi = min(a_right, b_right)
    return max(0, hi - lo + 1)


def do_em(params, mapped_file: str, em_backend: str = "torch", device="cuda"):
    """The classify entry point (doEM, fEM.h:466-1133). The EM rounds run on
    ``device`` (backend 'torch'), over the ranks made of it (backend
    'sharded', :func:`run_em`), on the host (backend 'numpy'), or on the one
    ``auto`` picks."""
    db_dir = params.db
    minimum_reads_per_best = params.minimum_reads_for_u

    meta = read_meta(mapped_file)
    n_unmapped = meta["ReadsNotMapped"]
    n_too_short = meta["ReadsTooShort"]
    n_total = meta["TotalReads"]
    n_mapped_meta = meta["ReadsMapped"]
    assert n_total == n_too_short + n_unmapped + n_mapped_meta

    # full taxonInfo is needed for location counts; filter to relevant later
    taxon_info_all = load_relevant_taxon_info(db_dir, set())
    table = load_mapping_table(mapped_file, taxon_info_all)
    if not table.taxon_list:
        raise RuntimeError("no relevant taxon IDs found in the mappings file")

    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))

    f_arr, n_iter = run_em(table, backend=em_backend, device=device)
    p = responsibilities(table, f_arr)

    # --- final outputs ------------------------------------------------------
    out_em = mapped_file + ".EM"
    out_wimp = mapped_file + ".EM.WIMP"
    out_ident = mapped_file + ".EM.lengthAndIdentitiesPerMappingUnit"
    out_r2t = mapped_file + ".EM.reads2Taxon"
    out_krona = mapped_file + ".EM.reads2Taxon.krona"
    out_cov = mapped_file + ".EM.contigCoverage"
    out_evidence = mapped_file + ".EM.evidenceUnknownSpecies"

    n_reads = len(table.read_ids)
    read_starts = np.searchsorted(table.read_of_line, np.arange(n_reads + 1))

    reads_per_taxon: Dict[str, int] = {}
    identities_per_taxon: Dict[str, List[float]] = {}
    coverage: Dict[str, Dict[str, np.ndarray]] = {}
    coverage_reads: Dict[str, Dict[str, np.ndarray]] = {}
    size_last_window: Dict[str, Dict[str, int]] = {}
    max_read_length = -1

    with open(out_em, "w") as em_out, open(out_ident, "w") as ident_out, open(
        out_r2t, "w"
    ) as r2t_out, open(out_krona, "w") as krona_out:
        ident_out.write("AnalysisLevel\tID\treadI\tIdentity\tLength\n")
        for ri in range(n_reads):
            lo, hi = int(read_starts[ri]), int(read_starts[ri + 1])
            for j in range(lo, hi):
                fields = table.lines[j].split(" ")
                fields[13] = _to_string(p[j])
                em_out.write(" ".join(fields) + "\n")
            # best mapping = first maximal p (getBestMapping, fEM.h:217-232)
            best_j = lo + int(np.argmax(p[lo:hi]))
            b_tax = table.taxon_list[table.taxon_of_line[best_j]]
            b_contig = table.contig_of_line[best_j]
            b_ident = float(table.identity[best_j])
            b_len = int(table.read_len[best_j])
            b_start = int(table.start[best_j])
            b_stop = int(table.stop[best_j])
            read_id = table.read_ids[ri]

            ident_out.write(
                f"EqualCoverageUnit\t{b_contig}\t{ri}\t{fmt_g(b_ident)}\t{b_len}\n"
            )
            r2t_out.write(f"{read_id}\t{b_tax}\n")
            krona_out.write(
                f"{read_id}\t{taxonomy.get_first_non_x_node(b_tax)}\t{fmt_g(p[best_j])}\n"
            )

            identities_per_taxon.setdefault(b_tax, []).append(b_ident)
            max_read_length = max(max_read_length, b_len)
            reads_per_taxon[b_tax] = reads_per_taxon.get(b_tax, 0) + 1

            contig_len = taxon_info_all[b_tax][b_contig]
            if b_contig not in coverage.setdefault(b_tax, {}):
                n_win, last = _contig_windows(contig_len)
                coverage[b_tax][b_contig] = np.zeros(n_win, np.int64)
                coverage_reads.setdefault(b_tax, {})[b_contig] = np.zeros(
                    n_win, np.int64
                )
                size_last_window.setdefault(b_tax, {})[b_contig] = last

            stop_pos = contig_len - 1 if b_stop >= contig_len else b_stop
            cov = coverage[b_tax][b_contig]
            cov_n = coverage_reads[b_tax][b_contig]
            pos = b_start
            while pos <= stop_pos:
                wi = pos // COVERAGE_WINDOW
                w_start = wi * COVERAGE_WINDOW
                w_stop = (wi + 1) * COVERAGE_WINDOW - 1
                if w_stop > contig_len:
                    w_stop = contig_len - 1
                cov[wi] += _overlap(w_start, w_stop, b_start, stop_pos)
                cov_n[wi] += 1
                pos += COVERAGE_WINDOW

        # unmapped (long-enough) reads -> taxon 0 (fEM.h:785-790)
        for _, read_id in read_unmapped_lengths(mapped_file):
            r2t_out.write(f"{read_id}\t0\n")
            krona_out.write(f"{read_id}\t0\t0\n")

    assert max_read_length > 0

    f_dict = {t: float(f_arr[i]) for i, t in enumerate(table.taxon_list)}
    clean_f(f_dict, reads_per_taxon, n_mapped_meta)
    produce_pot_file(
        out_wimp, taxonomy, f_dict, reads_per_taxon, n_total, n_unmapped, n_too_short
    )

    # --- contig coverage ----------------------------------------------------
    contig_to_taxon: Dict[str, str] = {}
    with open(out_cov, "w") as cov_out:
        cov_out.write(
            "taxonID\tequalCoverageUnitLabel\tcontigID\tstart\tstop\tnBases\treadCoverage\n"
        )
        for b_tax in sorted(coverage):  # std::map iteration order
            for b_contig in sorted(coverage[b_tax]):
                cov = coverage[b_tax][b_contig]
                for wi in range(cov.size):
                    w_len = (
                        size_last_window[b_tax][b_contig]
                        if wi == cov.size - 1
                        else COVERAGE_WINDOW
                    )
                    w_start = wi * COVERAGE_WINDOW
                    w_stop = (wi + 1) * COVERAGE_WINDOW - 1
                    n_bases = int(cov[wi])
                    cov_out.write(
                        f"{b_tax}\t{taxonomy.get_node(b_tax).scientific_name}\t"
                        f"{b_contig}\t{w_start}\t{w_stop}\t{n_bases}\t"
                        f"{fmt_g(n_bases / w_len)}\n"
                    )
                contig_to_taxon[b_contig] = b_tax

    # --- evidence for unknown species (fEM.h:846-1132) ----------------------
    best_tax = None
    best_median = None
    one_third_cut = None
    one_third_p = None
    for t in sorted(identities_per_taxon):
        idents = sorted(identities_per_taxon[t])
        if len(idents) >= 3 and len(idents) >= minimum_reads_per_best:
            median = idents[len(idents) // 2]
            if best_tax is None or median > best_median:
                best_median = median
                best_tax = t
                one_third_cut = idents[int(len(idents) * (1.0 / 3.0))]
                n_one = sum(1 for x in idents if x <= one_third_cut)
                one_third_p = n_one / len(idents)

    min_clear_run = max_read_length
    ns_per_window = get_ns_per_window(db_dir, COVERAGE_WINDOW, set(contig_to_taxon))

    g_windows: Dict[str, int] = {}
    g_usable: Dict[str, int] = {}
    g_usable_reads: Dict[str, int] = {}
    g_usable_zero: Dict[str, int] = {}

    for contig, n_list in sorted(ns_per_window.items()):
        t = contig_to_taxon[contig]
        n_win = len(n_list)
        # plain python ints: the size_t last-window underflow exceeds int64
        run_fwd = [0] * n_win
        run_bwd = [0] * n_win
        running = 0
        for wi in range(n_win):
            run_fwd[wi] = running
            w_len = (
                size_last_window[t][contig] if wi == n_win - 1 else COVERAGE_WINDOW
            )
            prop_n = n_list[wi] / w_len if w_len else 0.0
            running = (running + w_len) % _U64 if prop_n <= 0.02 else 0
        running = 0
        for wi in range(n_win - 1, -1, -1):
            run_bwd[wi] = running
            w_len = (
                size_last_window[t][contig] if wi == n_win - 1 else COVERAGE_WINDOW
            )
            prop_n = n_list[wi] / w_len if w_len else 0.0
            running = (running + w_len) % _U64 if prop_n <= 0.02 else 0

        usable = np.array(
            [a >= min_clear_run and b >= min_clear_run for a, b in zip(run_fwd, run_bwd)],
            dtype=bool,
        )
        cr = coverage_reads[t][contig]
        g_windows[t] = g_windows.get(t, 0) + n_win
        g_usable[t] = g_usable.get(t, 0) + int(usable.sum())
        g_usable_reads[t] = g_usable_reads.get(t, 0) + int(cr[usable].sum())
        g_usable_zero[t] = g_usable_zero.get(t, 0) + int((cr[usable] == 0).sum())

    with open(out_evidence, "w") as ev:
        ev.write(
            "taxonID\tspecies\tgenus\tnReads\tpropBottomThirdReadIdentities\t"
            "expectedPropBottomThirdReadIdentities\tpValue_BottomThirdReadIdentities\t"
            "coverageWindows_totalGenome\tcoverageWindows_usable\t"
            "coverageWindows_usable_averageCoverage\t"
            "coverageWindows_usable_coverageIsZero\t"
            "coverageWindows_usable_coverageIsZero_expected\t"
            "coverageWindows_usable_coverageIsZero_P\n"
        )
        for t in sorted(identities_per_taxon):
            idents = identities_per_taxon[t]
            prop_str = exp_str = pval_str = "NA"
            if best_tax is not None:
                n_one = sum(1 for x in idents if x <= one_third_cut)
                n_non = len(idents) - n_one
                e_one = one_third_p * len(idents)
                e_non = len(idents) - e_one
                assert e_one > 0 and e_non > 0
                exp_str = _to_string(one_third_p)
                stat = (n_one - e_one) ** 2 / e_one + (n_non - e_non) ** 2 / e_non
                prop_str = _to_string(n_one / len(idents))
                pval_str = _to_string(1 - spstats.chi2.cdf(stat, 1))

            avg_str = zexp_str = zp_str = "NA"
            if g_usable.get(t, 0) > 0:
                avg = g_usable_reads[t] / g_usable[t]
                avg_str = _to_string(avg)
                if avg == 0:
                    zexp_str = _to_string(g_usable[t])
                    zp_str = _to_string(1)
                else:
                    p0 = float(spstats.poisson.pmf(0, avg))
                    zexp_str = _to_string(g_usable[t] * p0)
                    if g_usable_zero[t] > 0:
                        below = float(
                            spstats.binom.cdf(g_usable_zero[t] - 1, g_usable[t], p0)
                        )
                        zp_str = _to_string(1 - below)
                    else:
                        zp_str = _to_string(1)

            up = taxonomy.get_upward_by_ranks(t, {"species", "genus"})
            ev.write(
                f"{t}\t{up['species']}\t{up['genus']}\t{len(idents)}\t"
                f"{prop_str}\t{exp_str}\t{pval_str}\t"
                f"{g_windows.get(t, 0)}\t{g_usable.get(t, 0)}\t{avg_str}\t"
                f"{g_usable_zero.get(t, 0)}\t{zexp_str}\t{zp_str}\n"
            )

    return f_dict, n_iter
