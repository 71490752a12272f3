"""The "U" (unknown species) classifier — parity with src/meta/fU.h.

Detects reads from genomes absent from the database by allowing attachment
to internal taxonomy nodes, with likelihoods from the precomputed
self-similarity distributions:

- per read, the best direct mapping per taxon and the best indirect
  attachment per upward node (getMappingLocations_U, fU.h:42-151);
- mapping qualities marginalize over a true-identity prior and the node's
  identity-shift distribution (compute_U_mappingQualities, fU.h:155-362) and
  are checkpointed to ``<mappings>.mapQ_U`` (fU.h:364-432);
- an EM over (direct, indirect) frequency pairs (fU.h:1246-1402);
- unmapped-read redistribution using P(identity=0 | node) (fU.h:1462-1628);
- outputs: .U.WIMP (+ .absoluteClassifiedAt), .U.reads2Taxon,
  .U.lengthAndIdentitiesPerTaxonID, .U.shiftedHistogramsPerTaxonID,
  .EM2U.details/summary.

Known divergence: .U.lengthAndIdentitiesPerTaxonID's Length column writes a
deterministic 0 where the reference prints uninitialized memory (the fU.h
print site never assigns its length local); see the write site below.

Counterpart: ``metamaps_tpu/engine/u.py``, copied unchanged (on the
port's own ``stats``, ``taxonomy``, ``io.mappings`` and ``engine.em``)
so that the port imports nothing of the JAX package. It is host code:
numpy, with scipy through ``stats``.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from .. import stats
from ..io.mappings import fmt_g, iter_reads_grouped, read_meta, read_unmapped_lengths, read_parameters_file
from ..taxonomy import RELEVANT_LEVEL_NAMES, Taxonomy, extract_taxon_id
from .em import load_relevant_taxon_info
from .u_helper import IdentityManager, IdentityReadLengthHistogram, TreeAdjustedIdentities


@dataclass
class ULocation:
    read_id: str
    taxon_id: str
    original_identity: float
    minimizer_union: int
    minimizer_intersection: int
    read_length: int
    p: float
    mapq: float
    direct: bool


def get_min_max_identities(mapped_file: str) -> Tuple[int, int]:
    """(fU.h:963-997)"""
    lo = hi = None
    for read_lines in iter_reads_grouped(mapped_file):
        for line in read_lines:
            f = line.split(" ")
            ii = int(float(f[9]) / 100.0 * 100 + 0.5)
            lo = ii if lo is None else min(lo, ii)
            hi = ii if hi is None else max(hi, ii)
    assert hi is not None and hi > 1
    return lo, hi


def get_mapping_locations_u(indirect_upward: Dict[str, List[str]], read_lines: List[str]) -> List[ULocation]:
    """(fU.h:42-151)"""
    read_id = read_lines[0].split(" ", 1)[0]
    read_length = int(read_lines[0].split(" ")[1])

    best_direct: Dict[str, ULocation] = {}
    best_indirect: Dict[str, ULocation] = {}
    for line in read_lines:
        f = line.split(" ")
        contig_taxon = extract_taxon_id(f[5])
        identity = float(f[9]) / 100.0
        inter = int(f[10])
        sketch = int(f[11])
        assert inter <= sketch and 0 <= identity <= 1
        loc = ULocation(read_id, contig_taxon, identity, sketch, inter, read_length, 0.0, 0.0, True)
        if contig_taxon not in best_direct or best_direct[contig_taxon].original_identity < identity:
            best_direct[contig_taxon] = loc
        for up in indirect_upward[contig_taxon]:
            loc_i = ULocation(read_id, up, identity, sketch, inter, read_length, 0.0, 0.0, False)
            if up not in best_indirect or best_indirect[up].original_identity < identity:
                best_indirect[up] = loc_i

    out = [best_direct[t] for t in sorted(best_direct)]
    out += [best_indirect[t] for t in sorted(best_indirect)]
    return out


def compute_u_mapping_qualities(locations: List[ULocation], im: IdentityManager, kmer_size: int):
    """(fU.h:155-362), vectorized over (readIdentity grid x locations x
    shift bins) — the U pipeline's hot path. Direct locations: ONE
    binom.pmf call on a [G, Ld] grid. Each indirect location: one call on
    its [G, B] (identity x qualifying-shift-bin) grid; the reference's
    inner normalization then makes the per-identity contribution exactly
    sum/sum = 1 wherever any qualifying term exists — reproduced
    faithfully (see _compute_u_mapping_qualities_scalar, the line-by-line
    oracle these results are pinned against)."""
    import numpy as np

    assert locations
    max_int_identity = -1
    for l in locations:
        l.mapq = 0.0
        l.p = 0.0
        if l.direct:
            ii = math.ceil(l.original_identity * 100)
            max_int_identity = max(max_int_identity, ii)
    assert 0 < max_int_identity <= 100
    max_ri = im.get_maximum_read_identity()
    assert max_int_identity <= max_ri
    min_ri_frac = im.get_minimum_read_identity() / 100.0

    ri = np.arange(max_int_identity, max_ri + 1)  # [G]
    ri_p = np.array([im.get_read_identity_p(int(x)) for x in ri])
    assert ((ri_p > 0) & (ri_p <= 1)).all()
    ri_frac = ri / 100.0

    # one flattened [G, T] likelihood grid for the whole read: direct
    # locations contribute one column each (identity = the grid), indirect
    # locations one column per nonzero shift bin (identity = grid * shift)
    # — a SINGLE binom.pmf ufunc call replaces G * (Ld + sum B) scalar ones
    shift_cache: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]] = {}
    spans: List[Tuple[ULocation, int, int, np.ndarray]] = []  # (loc, lo, hi, sp)
    t = 0
    for l in locations:
        if l.direct:
            spans.append((l, t, t + 1, None))
            t += 1
        else:
            key = (l.taxon_id, l.read_length)
            if key not in shift_cache:
                hist = im.get_original_u_histogram_one_read_length(
                    l.taxon_id, l.read_length
                )
                sk = np.array([s for s in hist if s != 0], np.float64)
                sp = np.array([hist[s] for s in hist if s != 0])
                shift_cache[key] = (sk, sp)
            sk, sp = shift_cache[key]
            spans.append((l, t, t + sk.size, sp))
            t += sk.size

    if t:
        G = ri_frac.size
        ident_mat = np.empty((G, t))
        cols_nk = np.empty(t)
        cols_union = np.empty(t)
        cols_inter = np.empty(t)
        for l, lo, hi, sp in spans:
            if sp is None:
                ident_mat[:, lo] = ri_frac
            elif hi > lo:
                sk, _ = shift_cache[(l.taxon_id, l.read_length)]
                ident_mat[:, lo:hi] = ri_frac[:, None] * (sk[None, :] / 100.0)
            cols_nk[lo:hi] = l.read_length - kmer_size + 1
            cols_union[lo:hi] = l.minimizer_union
            cols_inter[lo:hi] = l.minimizer_intersection
        assert (ident_mat > 0).all()
        il = stats.likelihood_observed_set_sizes_vec(
            kmer_size, cols_nk[None, :], ident_mat,
            cols_union[None, :], cols_inter[None, :],
        )  # [G, T]

    for l, lo, hi, sp in spans:
        if sp is None:  # direct
            l.mapq = float(ri_p @ il[:, lo])
        elif hi > lo:  # indirect with nonzero shift bins
            qual = ident_mat[:, lo:hi] > min_ri_frac
            any_qual = qual.any(axis=1)
            # the reference divides each qualifying term by the summed
            # p_sum (fU.h:155-362), so the per-identity indirect
            # contribution is EXACTLY 1 whenever any shift term qualifies —
            # p_sum itself never enters the value. At bench-scale sketch
            # sizes (s ~ 500-900) the binomial likelihoods can underflow
            # float64 to 0.0 even for qualifying terms; the mathematical
            # term/p_sum ratios still sum to 1, so no assert on p_sum > 0
            # (the reference never met this regime — its assert guards a
            # division we do not perform).
            l.mapq = float(ri_p @ np.where(any_qual, 1.0, 0.0))
        else:
            l.mapq = 0.0

    total = sum(l.mapq for l in locations)
    assert total > 0
    for l in locations:
        l.mapq /= total


def _compute_u_mapping_qualities_scalar(locations: List[ULocation], im: IdentityManager, kmer_size: int):
    """The original line-by-line port of compute_U_mappingQualities
    (fU.h:155-362) — kept as the parity oracle for the vectorized hot
    path above. Note: the reference's indirect inner normalization makes
    the per-readIdentity indirect likelihood exactly 1 whenever any shift
    term qualifies — reproduced faithfully."""
    assert locations
    max_int_identity = -1
    for l in locations:
        l.mapq = 0.0
        if l.direct:
            ii = math.ceil(l.original_identity * 100)
            max_int_identity = max(max_int_identity, ii)
        l.p = 0.0
    assert 0 < max_int_identity <= 100
    assert max_int_identity <= im.get_maximum_read_identity()

    # cache the raw shift distributions per (taxon, readLength)
    shift_cache: Dict[Tuple[str, int], Dict[int, float]] = {}

    for read_identity in range(max_int_identity, im.get_maximum_read_identity() + 1):
        ri_p = im.get_read_identity_p(read_identity)
        assert 0 < ri_p <= 1
        for l in locations:
            n_kmers = l.read_length - kmer_size + 1
            if l.direct:
                contrib = stats.likelihood_observed_set_sizes(
                    kmer_size, n_kmers, read_identity / 100.0,
                    l.minimizer_union, l.minimizer_intersection,
                )
            else:
                key = (l.taxon_id, l.read_length)
                if key not in shift_cache:
                    shift_cache[key] = im.get_original_u_histogram_one_read_length(
                        l.taxon_id, l.read_length
                    )
                shift = shift_cache[key]
                p_sum = 0.0
                contrib = 0.0
                for pass_gen in (1, 0):
                    for sk, sp in shift.items():
                        if sk == 0:
                            continue
                        shift_identity = (read_identity / 100.0) * (sk / 100.0)
                        assert shift_identity > 0
                        if shift_identity > im.get_minimum_read_identity() / 100.0:
                            il = stats.likelihood_observed_set_sizes(
                                kmer_size, n_kmers, shift_identity,
                                l.minimizer_union, l.minimizer_intersection,
                            )
                            if pass_gen:
                                p_sum += sp * il
                            else:
                                assert p_sum > 0
                                contrib += (sp * il) / p_sum
            l.mapq += ri_p * contrib

    total = sum(l.mapq for l in locations)
    assert total > 0
    for l in locations:
        l.mapq /= total


def generate_unknown_mapq_file(db_dir: str, mapped_file: str, im: IdentityManager,
                               taxonomy: Taxonomy, kmer_size: int):
    """(fU.h:364-432). Writes <mappings>.mapQ_U."""
    taxa = set()
    for read_lines in iter_reads_grouped(mapped_file):
        for line in read_lines:
            taxa.add(extract_taxon_id(line.split(" ")[5]))

    indirect_upward: Dict[str, List[str]] = {}
    for t in taxa:
        indirect_upward[t] = [
            u for u in taxonomy.get_upward_nodes(t)
            if im.tai.node_for_indirect_attachment(u)
        ]

    out_fn = mapped_file + ".mapQ_U"
    with open(out_fn, "w") as out:
        for read_lines in iter_reads_grouped(mapped_file):
            locations = get_mapping_locations_u(indirect_upward, read_lines)
            compute_u_mapping_qualities(locations, im, kmer_size)
            s = 0.0
            for l in locations:
                out.write(
                    f"{l.read_id} {l.taxon_id} {1 if l.direct else 0} "
                    f"{fmt_g(l.mapq)} {fmt_g(l.original_identity)}\n"
                )
                s += l.mapq
            assert abs(1 - s) <= 1e-3
    return out_fn, indirect_upward


def _get_mappings_with_p(f_pair, read_lines: List[str]) -> Tuple[List[ULocation], float]:
    """(fU.h:1170-1231) — parse mapQ_U lines and compute posteriors."""
    f_direct, f_indirect = f_pair
    out = []
    l_read = 0.0
    for line in read_lines:
        fields = line.split(" ")
        assert len(fields) == 5
        loc = ULocation(fields[0], fields[1], float(fields[4]), 0, 0, 0, 0.0,
                        float(fields[3]), bool(int(fields[2])))
        assert 0 <= loc.mapq <= 1
        l = (f_direct if loc.direct else f_indirect)[loc.taxon_id] * loc.mapq
        l_read += l
        loc.p = l
        out.append(loc)
    assert l_read > 0
    for loc in out:
        loc.p /= l_read
    return out, l_read


def clean_f_u(f_pair, assigned, distributed_reads: int):
    """(fU.h:1676-1743)"""
    f_direct, f_indirect = f_pair
    a_direct, a_indirect = assigned
    min_freq = 0.9 / distributed_reads
    combined: Dict[str, float] = {}
    for d in (f_direct, f_indirect):
        for t, v in d.items():
            combined[t] = combined.get(t, 0.0) + v
    for t, v in combined.items():
        if v < min_freq and t not in a_direct and t not in a_indirect:
            f_direct.pop(t, None)
            f_indirect.pop(t, None)
    s = sum(f_direct.values()) + sum(f_indirect.values())
    assert s > 0
    for d in (f_direct, f_indirect):
        for t in d:
            d[t] /= s


def produce_pot_file_u(out_fn: str, taxonomy: Taxonomy, freq_triplet, read_count_pair,
                       mappable_reads: int, mappable_taxon_ids: Set[str]):
    """(fU.h:731-942). freq_triplet = (direct, indirect, fromUnmapped)."""
    f0, f1, f2 = freq_triplet
    rc0, rc1 = read_count_pair
    combined = set(f0) | set(f1) | set(f2) | set(rc0) | set(rc1)

    target_levels = RELEVANT_LEVEL_NAMES
    freq_per_level: Dict[str, Tuple[Dict, Dict, Dict]] = {}
    rc_per_level: Dict[str, Tuple[Dict, Dict]] = {}
    keys_per_level: Dict[str, Set[str]] = {}
    classified_at_freq: Dict[str, float] = {}
    classified_at_reads: Dict[str, int] = {}

    for taxon in sorted(combined):
        up = taxonomy.get_upward_by_ranks(taxon, target_levels)
        up["definedAndHypotheticalGenomes"] = taxon
        up["definedGenomes"] = taxon

        level_label = (
            "definedGenomes" if taxon in mappable_taxon_ids
            else taxonomy.get_node(taxon).rank
        )
        combined_f = f0.get(taxon, 0.0) + f1.get(taxon, 0.0) + f2.get(taxon, 0.0)
        combined_reads = rc0.get(taxon, 0) + rc1.get(taxon, 0)
        classified_at_freq[level_label] = classified_at_freq.get(level_label, 0.0) + combined_f
        classified_at_reads[level_label] = classified_at_reads.get(level_label, 0) + combined_reads

        for level, value in up.items():
            if level == "definedGenomes" and value not in mappable_taxon_ids:
                continue
            keys_per_level.setdefault(level, set()).add(value)
            fl = freq_per_level.setdefault(level, ({}, {}, {}))
            rl = rc_per_level.setdefault(level, ({}, {}))
            for d in (*fl, *rl):
                d.setdefault(value, 0)
            fl[0][value] += f0.get(taxon, 0.0)
            fl[1][value] += f1.get(taxon, 0.0)
            fl[2][value] += f2.get(taxon, 0.0)
            rl[0][value] += rc0.get(taxon, 0)
            rl[1][value] += rc1.get(taxon, 0)

    with open(out_fn + ".absoluteClassifiedAt", "w") as out:
        out.write("Level\tf\tnReads\n")
        for level in sorted(classified_at_freq):
            out.write(f"{level}\t{fmt_g(classified_at_freq[level])}\t{classified_at_reads[level]}\n")

    with open(out_fn, "w") as out:
        out.write(
            "AnalysisLevel\ttaxonID\tName\treadsDirectlyAssigned_inDB\t"
            "readsDirectlyAssigned_potentiallyNovel\tfrDirect\tfrIndirect\t"
            "frFromUnmapped\tAbsolute\tPotFrequency\n"
        )
        for level in sorted(keys_per_level):
            fl = freq_per_level[level]
            rl = rc_per_level[level]
            level_freq_sum = 0.0
            level_read_sum = 0
            for taxon in sorted(keys_per_level[level]):
                if taxon == "Undefined":
                    continue
                name = taxonomy.get_node(taxon).scientific_name
                reads = rl[0][taxon] + rl[1][taxon]
                freq = fl[0][taxon] + fl[1][taxon] + fl[2][taxon]
                out.write(
                    f"{level}\t{taxon}\t{name}\t{rl[0][taxon]}\t{rl[1][taxon]}\t"
                    f"{fmt_g(fl[0][taxon])}\t{fmt_g(fl[1][taxon])}\t{fmt_g(fl[2][taxon])}\t"
                    f"{reads}\t{fmt_g(freq)}\n"
                )
                level_read_sum += reads
                level_freq_sum += freq
            unclassified_reads = mappable_reads - level_read_sum
            assert unclassified_reads >= 0
            level_freq_sum = min(level_freq_sum, 1.0)
            out.write(
                f"{level}\t0\tUnclassified\t0\t0\t0\t0\t0\t"
                f"{unclassified_reads}\t{fmt_g(1 - level_freq_sum)}\n"
            )


def produce_shifted_histograms(out_fn: str, im: IdentityManager, f_pair):
    """(fU.h:550-594)"""
    f_direct, f_indirect = f_pair
    with open(out_fn, "w") as out:
        out.write("taxonID\tdirectIndirect\tidentity\tP\n")
        for t in sorted(f_direct):
            if f_direct[t] > 1e-5:
                h = im.get_histogram_for_node(t, True)
                assert abs(1 - sum(h.values())) <= 1e-3
                for i in sorted(h):
                    out.write(f"{t}\tdirect\t{i}\t{fmt_g(h[i])}\n")
        for t in sorted(f_indirect):
            h = im.get_histogram_for_node(t, False)
            assert abs(1 - sum(h.values())) <= 1e-3
            for i in sorted(h):
                out.write(f"{t}\tindirect\t{i}\t{fmt_g(h[i])}\n")


def produce_em2u(mapped_file: str, taxonomy: Taxonomy):
    """(fU.h:645-729)"""
    details: Dict[str, Dict[str, int]] = {}
    levels: Dict[str, Dict[str, int]] = {}
    with open(mapped_file + ".EM.reads2Taxon") as f_em, open(mapped_file + ".U.reads2Taxon") as f_u:
        for line_em, line_u in zip(f_em, f_u):
            line_em, line_u = line_em.rstrip("\n"), line_u.rstrip("\n")
            if not line_em:
                continue
            rid_em, tax_em = line_em.split("\t")
            rid_u, tax_u = line_u.split("\t")
            assert rid_em == rid_u
            if tax_em == "0":
                continue
            details.setdefault(tax_em, {}).setdefault(tax_u, 0)
            details[tax_em][tax_u] += 1
            level = "identical" if tax_em == tax_u else taxonomy.get_node(tax_u).rank
            levels.setdefault(tax_em, {}).setdefault(level, 0)
            levels[tax_em][level] += 1
    with open(mapped_file + ".EM2U.details", "w") as out:
        for outer in sorted(details):
            for inner in sorted(details[outer]):
                out.write(f"{outer}\t{inner}\t{details[outer][inner]}\n")
    with open(mapped_file + ".EM2U.summary", "w") as out:
        for outer in sorted(levels):
            for inner in sorted(levels[outer]):
                out.write(f"{outer}\t{inner}\t{levels[outer][inner]}\n")


def do_u(params, mapped_file: str):
    """The classifyU driver (doU, fU.h:1085-1674)."""
    db_dir = params.db
    taxonomy = Taxonomy(os.path.join(db_dir, "taxonomy"))

    taxa_in_mappings = set()
    for read_lines in iter_reads_grouped(mapped_file):
        for line in read_lines:
            taxa_in_mappings.add(extract_taxon_id(line.split(" ")[5]))

    taxon_info = load_relevant_taxon_info(db_dir, set())
    mappable_taxa = set(taxon_info)

    fn_fitted = mapped_file + ".EM.lengthAndIdentitiesPerMappingUnit"
    if not os.path.exists(fn_fitted):
        raise RuntimeError(f"{fn_fitted} missing — run the EM step first")

    idty_minmax = get_min_max_identities(mapped_file)
    ih = IdentityReadLengthHistogram()
    ih.read_from_em_output(fn_fitted, idty_minmax, params.minimum_reads_for_u)

    tai = TreeAdjustedIdentities()
    tai.read_from_file(os.path.join(db_dir, "selfSimilarities.txt"), taxa_in_mappings, taxonomy)

    im = IdentityManager(ih, tai)
    kmer_size = int(read_parameters_file(mapped_file)["kmerSize"])
    mapq_u_fn, indirect_upward = generate_unknown_mapq_file(db_dir, mapped_file, im, taxonomy, kmer_size)

    meta = read_meta(mapped_file)
    n_total, n_too_short = meta["TotalReads"], meta["ReadsTooShort"]
    n_unmapped, n_mapped = meta["ReadsNotMapped"], meta["ReadsMapped"]
    assert n_total == n_too_short + n_unmapped + n_mapped
    n_mappable = n_total - n_too_short
    unmapped_lengths = [l for l, _ in read_unmapped_lengths(mapped_file)]
    assert len(unmapped_lengths) == n_unmapped

    relevant_direct = set(taxa_in_mappings)
    relevant_indirect = set()
    for t in taxa_in_mappings:
        relevant_indirect.update(indirect_upward[t])

    n_combined = len(relevant_direct) + len(relevant_indirect)
    f_direct = {t: 1.0 / n_combined for t in relevant_direct}
    f_indirect = {t: 1.0 / n_combined for t in relevant_indirect}

    # --- EM-U loop (fU.h:1246-1402) ----------------------------------------
    ll_last = None
    iteration = 0
    while True:
        f_next_d = {t: 0.0 for t in f_direct}
        f_next_i = {t: 0.0 for t in f_indirect}
        ll = 0.0
        for read_lines in iter_reads_grouped(mapq_u_fn):
            locs, l_read = _get_mappings_with_p((f_direct, f_indirect), read_lines)
            ll += math.log(l_read)
            for loc in locs:
                (f_next_d if loc.direct else f_next_i)[loc.taxon_id] += loc.p

        pre_norm = sum(f_next_d.values()) + sum(f_next_i.values())
        assert abs(n_mapped - pre_norm) <= 1e-2
        for d in (f_next_d, f_next_i):
            for t in d:
                d[t] /= pre_norm

        if ll_last is not None:
            ll_diff = ll - ll_last
            assert ll_diff >= -1e-6
            if ll_diff <= 1 and (1 - ll / ll_last) < 1e-4:
                f_direct, f_indirect = f_next_d, f_next_i
                break
        f_direct, f_indirect = f_next_d, f_next_i
        ll_last = ll
        iteration += 1

    # --- final pass --------------------------------------------------------
    assigned_d: Dict[str, int] = {}
    assigned_i: Dict[str, int] = {}
    with open(mapped_file + ".U.lengthAndIdentitiesPerTaxonID", "w") as ident_out, open(
        mapped_file + ".U.reads2Taxon", "w"
    ) as r2t_out:
        # Length column: the reference prints uninitialized memory here
        # (fU.h declares the read-length local but never assigns it before
        # the print) — we write a deterministic 0 instead. Pinned in
        # tests/test_u.py; a byte-diff against reference output must ignore
        # this column.
        ident_out.write("taxonID\tdirectIndirect\ttaxonName\tIdentity\tLength\n")
        for read_lines in iter_reads_grouped(mapq_u_fn):
            locs, _ = _get_mappings_with_p((f_direct, f_indirect), read_lines)
            best = max(locs, key=lambda l: l.p)  # first max kept by max()
            best = next(l for l in locs if l.p == best.p)
            d = assigned_d if best.direct else assigned_i
            d[best.taxon_id] = d.get(best.taxon_id, 0) + 1
            ident_out.write(
                f"{best.taxon_id}\t{'direct' if best.direct else 'indirect'}\t"
                f"{taxonomy.get_node(best.taxon_id).scientific_name}\t"
                f"{fmt_g(best.original_identity)}\t0\n"
            )
            r2t_out.write(f"{best.read_id}\t{best.taxon_id}\n")
        for _, read_id in read_unmapped_lengths(mapped_file):
            r2t_out.write(f"{read_id}\t0\n")

    clean_f_u((f_direct, f_indirect), (assigned_d, assigned_i), n_mapped)

    # --- unmapped-read redistribution (fU.h:1462-1628) ---------------------
    f0: Dict[str, float] = {}
    f1: Dict[str, float] = {}
    f2: Dict[str, float] = {}
    if unmapped_lengths:
        prop_unmapped_avg = {}
        for t in f_indirect:
            s = sum(im.get_identity_p(0, t, rl, False) for rl in unmapped_lengths)
            prop_unmapped_avg[t] = s / len(unmapped_lengths)

        want_add_total = 0.0
        want_add = {}
        for t, freq in f_indirect.items():
            approx_reads = n_mapped * freq
            expected_mapped = 1 - prop_unmapped_avg[t]
            would_like = (1.0 / expected_mapped) * approx_reads - approx_reads
            assert would_like >= 0
            want_add_total += would_like
            want_add[t] = would_like

        scale = 1.0
        if want_add_total > n_unmapped:
            scale = n_unmapped / want_add_total
        leave_unassigned = max(0.0, n_unmapped - want_add_total * scale)
        leave_prop = leave_unassigned / n_mappable

        for t, v in f_direct.items():
            f0[t] = v * n_mapped
        for t, v in f_indirect.items():
            f1[t] = v * n_mapped
            f2[t] = scale * want_add[t]

        total = sum(f0.values()) + sum(f1.values()) + sum(f2.values())
        assert abs((total + leave_unassigned) - n_mappable) <= 1e-3
        for d in (f0, f1, f2):
            for t in d:
                d[t] = d[t] / total * (1 - leave_prop)
    else:
        f0 = dict(f_direct)
        f1 = dict(f_indirect)
        total = sum(f0.values()) + sum(f1.values())
        for d in (f0, f1):
            for t in d:
                d[t] /= total

    produce_pot_file_u(
        mapped_file + ".U.WIMP", taxonomy, (f0, f1, f2), (assigned_d, assigned_i),
        n_mappable, mappable_taxa,
    )
    produce_shifted_histograms(
        mapped_file + ".U.shiftedHistogramsPerTaxonID", im, (f_direct, f_indirect)
    )
    produce_em2u(mapped_file, taxonomy)
    return (f0, f1, f2)
