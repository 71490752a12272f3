"""Run parameters, mirroring the reference skch::Parameters
(src/map/include/map_parameters.hpp:32-92) and the CLI derivation rules
(src/map/include/parseCmdArgs.hpp:255-434): k defaults to 16 (DNA), p-value
1e-3, minReadLen 1000, pi 80; window size is derived from the p-value when
not given, and the p-value re-estimated when the window is given.

Counterpart: ``metamaps_tpu/params.py``, copied unchanged so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from . import stats


@dataclass
class Parameters:
    kmer_size: int = 16
    window_size: int = 0
    min_read_length: int = 1000
    alphabet_size: int = 4
    reference_size: int = 0
    percentage_identity: float = 80.0
    p_value: float = 1e-3
    threads: int = 1
    ref_sequences: List[str] = field(default_factory=list)
    query_sequences: List[str] = field(default_factory=list)
    out_file_name: str = ""
    report_all: bool = False
    index: str = ""
    maximum_memory: int = 0
    db: str = ""
    mappings_for_classification: str = ""
    minimum_reads_for_u: int = 10000
    engine: str = "auto"  # mapping engine: auto | jax | oracle

    def derive_window_size(self, window_size_given: bool = False):
        """Apply the reference's window/p-value derivation
        (parseCmdArgs.hpp:363-382)."""
        if window_size_given:
            s = self.min_read_length * 2 // self.window_size
            self.p_value = stats.estimate_pvalue(
                s,
                self.kmer_size,
                self.alphabet_size,
                self.percentage_identity,
                self.min_read_length,
                self.reference_size,
            )
        else:
            self.window_size = stats.recommended_window_size(
                self.p_value,
                self.kmer_size,
                self.alphabet_size,
                self.percentage_identity,
                self.min_read_length,
                self.reference_size,
            )
        return self
