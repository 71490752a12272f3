"""Probability tables for the "unknown species" (U) pipeline.

Parity with src/meta/fU_helper.h:

- :class:`IdentityReadLengthHistogram` — identity/read-length histograms
  fitted from the EM output's best mapping unit (readFromEMOutput,
  fU_helper.h:80-314), with the reference's 0.5^d decay fill-in for
  unobserved identity bins;
- :class:`TreeAdjustedIdentities` — per-node selfSimilarities.txt tables
  P(identity | read length, novel genome attached at node)
  (fU_helper.h:362-478);
- :class:`IdentityManager` — cached shifted-identity histograms: the
  convolution of the observed-identity histogram with a node's shift
  distribution (fU_helper.h:505-877).

Counterpart: ``metamaps_tpu/engine/u_helper.py``, copied unchanged so
that the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Set



class IdentityReadLengthHistogram:
    def __init__(self):
        self.minimum_identity = None
        self.maximum_identity = None
        self.identity_histogram: Dict[int, float] = {}
        self.read_length_histogram: Dict[int, float] = {}

    def identity_keys(self) -> List[int]:
        return sorted(self.identity_histogram)

    def get_identity_p(self, idty: int) -> float:
        assert 0 <= idty <= 100
        if idty in self.identity_histogram:
            return self.identity_histogram[idty]
        raise RuntimeError(
            f"identity {idty} outside fitted range "
            f"[{self.minimum_identity}, {self.maximum_identity}]"
        )

    def read_from_em_output(self, fn: str, idty_minmax, minimum_reads_per_contig: int):
        identities_per_unit: Dict[str, List[float]] = {}
        lengths_per_unit: Dict[str, List[int]] = {}
        with open(fn) as f:
            header = f.readline().rstrip("\n").split("\t")
            assert header[1] == "ID" and header[3] == "Identity" and header[4] == "Length"
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                assert len(fields) == 5
                identities_per_unit.setdefault(fields[1], []).append(float(fields[3]))
                lengths_per_unit.setdefault(fields[1], []).append(int(fields[4]))

        all_min, all_max = idty_minmax
        if all_max < 100:
            all_max += 1

        best_contig = None
        best_median = None
        for contig, idents in identities_per_unit.items():
            if len(idents) > minimum_reads_per_contig:
                si = sorted(idents)
                median = si[len(si) // 2]
                if best_contig is None or median > best_median:
                    best_median = median
                    best_contig = contig
        if best_contig is None:
            raise RuntimeError(
                "Cannot fit read length and identity distribution: no contig "
                f"has more than {minimum_reads_per_contig} assigned reads"
            )

        idents = identities_per_unit[best_contig]
        lengths = lengths_per_unit[best_contig]

        hist_int: Dict[int, int] = {}
        min_def = max_def = None
        for i in idents:
            ii = int(i * 100 + 0.5)
            assert 0 <= ii <= 100
            hist_int[ii] = hist_int.get(ii, 0) + 1
            min_def = ii if min_def is None else min(min_def, ii)
            max_def = ii if max_def is None else max(max_def, ii)
        assert min_def is not None and min_def < max_def
        assert all_min <= min_def and all_max >= max_def

        hist = {i: n / len(idents) for i, n in hist_int.items()}

        # fill-in for unobserved bins: exponential 0.5^d decay from the
        # nearest defined bin (outside the defined range), max of left/right
        # decay inside it (fU_helper.h:196-272)
        internal_add: Dict[int, float] = {}
        for i in range(all_min, all_max + 1):
            if i in hist:
                continue
            if i < min_def:
                hist[i] = 0.5 ** (min_def - i) * hist[min_def]
            elif i > max_def:
                hist[i] = 0.5 ** (i - max_def) * hist[max_def]
            else:
                lo = i - 1
                while lo not in hist or lo in internal_add:
                    lo -= 1
                hi = i + 1
                while hi not in hist or hi in internal_add:
                    hi += 1
                from_left = 0.5 ** (i - lo) * hist[lo]
                from_right = 0.5 ** (hi - i) * hist[hi]
                internal_add[i] = max(from_left, from_right)
        hist.update(internal_add)

        total = sum(hist.values())
        self.identity_histogram = {i: p / total for i, p in hist.items()}
        self.minimum_identity = all_min
        self.maximum_identity = all_max

        rl_int: Dict[int, int] = {}
        for l in lengths:
            l1000 = 1000 * int(l / 1000 + 0.5)
            rl_int[l1000] = rl_int.get(l1000, 0) + 1
        self.read_length_histogram = {l: n / len(lengths) for l, n in rl_int.items()}

    def get_read_length_p(self, read_length: int) -> float:
        ls = sorted(self.read_length_histogram)
        if read_length < ls[0]:
            return self.read_length_histogram[ls[0]]
        if read_length >= ls[-1]:
            return self.read_length_histogram[ls[-1]]
        for i in range(len(ls) - 1):
            if ls[i] <= read_length < ls[i + 1]:
                diff = ls[i + 1] - ls[i]
                w_right = (read_length - ls[i]) / diff
                return (
                    self.read_length_histogram[ls[i]] * (1 - w_right)
                    + self.read_length_histogram[ls[i + 1]] * w_right
                )
        raise AssertionError


class TreeAdjustedIdentities:
    """selfSimilarities.txt: node -> readLength -> identity -> P."""

    def __init__(self):
        self.D: Dict[str, Dict[int, Dict[int, float]]] = {}
        self.source_genomes: Dict[str, int] = {}

    def node_for_indirect_attachment(self, taxon_id: str) -> bool:
        return taxon_id in self.D

    def read_from_file(self, fn: str, mappings_taxon_ids: Set[str], taxonomy):
        relevant = set()
        for t in mappings_taxon_ids:
            relevant.add(t)
            relevant.update(taxonomy.get_upward_nodes(t))
        with open(fn) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                node_id = fields[0]
                read_length = int(fields[1])
                identity = int(fields[2])
                p = float(fields[3])
                assert 0 <= identity <= 100 and 0 <= p <= 1
                if node_id in relevant:
                    self.D.setdefault(node_id, {}).setdefault(read_length, {})[identity] = p
                    if len(fields) > 4 and fields[4]:
                        n_src = len(fields[4].split(";"))
                        assert n_src >= 2
                        if node_id in self.source_genomes:
                            assert self.source_genomes[node_id] == n_src
                        self.source_genomes[node_id] = n_src

    def two_closest_read_lengths(self, taxon_id: str, target: int) -> List[int]:
        ls = sorted(self.D[taxon_id])
        if target < ls[0]:
            return [ls[0]]
        if target >= ls[-1]:
            return [ls[-1]]
        for i in range(len(ls) - 1):
            if ls[i] <= target < ls[i + 1]:
                return [ls[i], ls[i + 1]]
        raise AssertionError


class IdentityManager:
    def __init__(self, ih: IdentityReadLengthHistogram, tai: TreeAdjustedIdentities):
        self.ih = ih
        self.tai = tai
        self._indirect_cache: Dict[str, Dict[int, float]] = {}

    def get_minimum_read_identity(self) -> int:
        return self.ih.minimum_identity

    def get_maximum_read_identity(self) -> int:
        return self.ih.maximum_identity

    def get_read_identity_p(self, idty: int) -> float:
        return self.ih.get_identity_p(idty)

    def get_identity_p(self, identity: int, taxon_id: str, read_length: int, direct: bool) -> float:
        if direct:
            p = self.ih.get_identity_p(identity)
            return 1e-4 if p == 0 else p
        cache = self._indirect_cache.setdefault(taxon_id, {})
        if identity not in cache:
            hist = self.get_shifted_identity_histogram(taxon_id)
            cache[identity] = hist.get(identity, 0.0)
        return cache[identity]

    def get_histogram_for_node(self, taxon_id: str, direct: bool) -> Dict[int, float]:
        if direct:
            return dict(self.ih.identity_histogram)
        return self.get_shifted_identity_histogram(taxon_id)

    def get_original_u_histogram_one_read_length(self, taxon_id: str, read_length: int) -> Dict[int, float]:
        """Raw (uncolvolved) shift distribution interpolated between the two
        closest simulated read lengths (fU_helper.h:607-660)."""
        closest = self.tai.two_closest_read_lengths(taxon_id, read_length)
        if len(closest) == 1:
            return dict(self.tai.D[taxon_id][closest[0]])
        l1, l2 = closest
        w_right = (read_length - l1) / (l2 - l1)
        h1 = self.tai.D[taxon_id][l1]
        h2 = self.tai.D[taxon_id][l2]
        out = {}
        for k in set(h1) | set(h2):
            out[k] = h1.get(k, 0.0) * (1 - w_right) + h2.get(k, 0.0) * w_right
        assert abs(1 - sum(out.values())) <= 1e-3
        return out

    def get_shifted_identity_histogram(self, taxon_id: str) -> Dict[int, float]:
        """Convolution of the observed-identity histogram with the node's
        shift distribution, marginalized over simulated read lengths
        weighted by the fitted read-length histogram (fU_helper.h:734-807)."""
        out: Dict[int, float] = {}
        total = 0.0
        for read_length, shift_hist in self.tai.D[taxon_id].items():
            rl_p = self.ih.get_read_length_p(read_length)
            for k1, p1 in self.ih.identity_histogram.items():
                for k2, p2 in shift_hist.items():
                    new_k = (k1 / 100.0) * (k2 / 100.0)
                    nk = int(new_k * 100 + 0.5)
                    p = rl_p * p1 * p2
                    if nk < self.ih.minimum_identity:
                        nk = 0
                    out[nk] = out.get(nk, 0.0) + p
                    total += p
        assert total > 0
        return {k: v / total for k, v in out.items()}

    @staticmethod
    def convoluted_histogram(ih: IdentityReadLengthHistogram, additional: Dict[int, float]) -> Dict[int, float]:
        """(fU_helper.h:809-876)"""
        assert abs(1 - sum(additional.values())) <= 1e-3
        out: Dict[int, float] = {}
        for k1, p1 in ih.identity_histogram.items():
            for k2, p2 in additional.items():
                nk = int((k1 / 100.0) * (k2 / 100.0) * 100 + 0.5)
                if nk < ih.minimum_identity:
                    nk = 0
                out[nk] = out.get(nk, 0.0) + p1 * p2
        assert abs(1 - sum(out.values())) <= 1e-3
        return out
