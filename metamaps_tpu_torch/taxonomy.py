"""NCBI taxonomy handling (reference: src/meta/taxonomy.h and
perlLib/taxTree.pm).

Parses names.dmp / nodes.dmp (and merged.dmp where needed) with the
reference's field splitting (collapse ``\\s*|\\s*`` to ``|``). Node ids are
strings because MetaMaps databases add 'x'-prefixed pseudo-nodes to
disambiguate multiple genomes under one taxon
(annotateRefSeqSequencesWithUniqueTaxonIDs.pl).

Counterpart: ``metamaps_tpu/taxonomy.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

_SPLIT_RE = re.compile(r"\s*\|\s*")


@dataclass
class TaxonNode:
    id: str
    parent_id: str
    rank: str
    scientific_name: str = ""
    genbank_common_name: str = ""
    children: Set[str] = field(default_factory=set)


class Taxonomy:
    def __init__(self, directory: str):
        fn_names = os.path.join(directory, "names.dmp")
        fn_nodes = os.path.join(directory, "nodes.dmp")

        names: Dict[str, dict] = {}
        with open(fn_names) as f:
            for line in f:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                parts = _SPLIT_RE.split(line)
                node_id, name, _, ntype = parts[0], parts[1], parts[2], parts[3]
                d = names.setdefault(node_id, {})
                if ntype == "scientific name":
                    d["scientific_name"] = name
                elif ntype == "genbank common name":
                    d["genbank_common_name"] = name

        self.nodes: Dict[str, TaxonNode] = {}
        with open(fn_nodes) as f:
            for line in f:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                parts = _SPLIT_RE.split(line)
                node_id, parent, rank = parts[0], parts[1], parts[2]
                if node_id not in names:
                    raise RuntimeError(f"no name for taxon ID {node_id}")
                self.nodes[node_id] = TaxonNode(
                    id=node_id,
                    parent_id=parent,
                    rank=rank,
                    scientific_name=names[node_id].get("scientific_name", ""),
                    genbank_common_name=names[node_id].get("genbank_common_name", ""),
                )
        for n in self.nodes.values():
            if n.parent_id != "1" and n.parent_id in self.nodes:
                self.nodes[n.parent_id].children.add(n.id)

        self.merged: Dict[str, str] = {}
        fn_merged = os.path.join(directory, "merged.dmp")
        if os.path.exists(fn_merged):
            self.merged = read_merged(directory)

    def know_node(self, node_id: str) -> bool:
        return node_id in self.nodes

    def find_current_node_id(self, original_id: str) -> str:
        """Translate a possibly-outdated NCBI taxon ID to its current node by
        following the merged.dmp chain (taxTree::findCurrentNodeID,
        taxTree.pm:765-795). Non-numeric or '0' IDs pass through."""
        if original_id == "0" or not original_id.isdigit():
            return original_id
        if original_id in self.nodes:
            return original_id
        running = original_id
        while running in self.merged:
            running = self.merged[running]
        if running in self.nodes:
            return running
        raise RuntimeError(
            f"Cannot translate ID {original_id} (running {running})"
        )

    def get_node(self, node_id: str) -> TaxonNode:
        return self.nodes[node_id]

    def get_first_non_x_node(self, node_id: str) -> str:
        """Strip MetaMaps-internal 'x…' pseudo-nodes (taxonomy.h:51-74)."""
        nid = node_id
        while "x" in nid:
            nid = self.nodes[nid].parent_id
        return nid

    def get_upward_nodes(self, node_id: str, include_start: bool = True) -> List[str]:
        assert node_id in self.nodes, node_id
        out = [node_id] if include_start else []
        while node_id != "1":
            node_id = self.nodes[node_id].parent_id
            out.append(node_id)
        return out

    def get_upward_by_ranks(
        self, node_id: str, target_ranks: Optional[Set[str]] = None
    ) -> Dict[str, str]:
        """rank -> node id along the upward path; missing target ranks map to
        'Undefined' (taxonomy.h:76-112)."""
        out: Dict[str, str] = {}
        for n in self.get_upward_nodes(node_id):
            rank = self.nodes[n].rank
            if target_ranks and rank not in target_ranks:
                continue
            if rank != "no rank":
                if rank in out:
                    raise RuntimeError(
                        f"node {node_id} has multiple entries for rank {rank}"
                    )
                out[rank] = n
        if target_ranks:
            for r in target_ranks:
                out.setdefault(r, "Undefined")
        return out

    # --- tree utilities used by the Perl-tooling equivalents ---------------

    def descendants(self, node_id: str) -> List[str]:
        out = []
        stack = [node_id]
        while stack:
            cur = stack.pop()
            for c in self.nodes[cur].children:
                out.append(c)
                stack.append(c)
        return out

    def lowest_common_ancestor(self, ids: List[str]) -> str:
        paths = [list(reversed(self.get_upward_nodes(i))) for i in ids]
        lca = "1"
        for level in zip(*paths):
            if all(x == level[0] for x in level):
                lca = level[0]
            else:
                break
        return lca


RELEVANT_LEVEL_NAMES = {"species", "genus", "family", "order", "phylum", "superkingdom"}

_TAXON_ID_RE = re.compile(r"kraken:taxid\|(x?\d+)")


def read_merged(directory: str) -> Dict[str, str]:
    """Parse merged.dmp: old taxon ID -> merged-into ID
    (taxTree::readMerged, taxTree.pm:737-763)."""
    fn = os.path.join(directory, "merged.dmp")
    if not os.path.exists(fn):
        raise RuntimeError(f"File {fn} missing, but want to read merged nodes")
    merged: Dict[str, str] = {}
    with open(fn) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            line = re.sub(r"\t?\|$", "", line)
            parts = line.split("\t|\t")
            if len(parts) != 2:
                raise RuntimeError(f"malformed merged.dmp line: {line!r}")
            if parts[0] in merged:
                raise RuntimeError(f"duplicate merged.dmp entry {parts[0]}")
            merged[parts[0]] = parts[1]
    return merged


def extract_taxon_id(contig_id: str) -> str:
    """Taxon id embedded in a contig identifier (fEM.h:1396-1414,
    Util.pm:46-57)."""
    m = _TAXON_ID_RE.search(contig_id)
    if not m:
        raise RuntimeError(
            f"Could not extract taxon ID from contig identifier '{contig_id}'"
        )
    return m.group(1)
