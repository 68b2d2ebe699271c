"""Inputs of one run, made from the traffic file's parameters and the seed.

A traffic file (gpubench/traffic/<name>.json) holds the parameters of
the simulation: the genome, the reads, and for a polishing job the
contigs cut from the genome and their draft.  `make_inputs` turns them
into the job's inputs with its truth, the same for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from gpubench.gen import simulate


@dataclasses.dataclass
class Inputs:
    kind: str                                  # "correct" or "polish"
    genome: np.ndarray
    reads: List[simulate.Read]
    # polish only: the draft contigs and their truth, by name, in order
    draft: Optional[Dict[str, np.ndarray]] = None
    truth_contigs: Optional[Dict[str, np.ndarray]] = None

    def queries(self) -> List[Tuple[str, np.ndarray]]:
        """What the job corrects: the reads, or the draft contigs."""
        if self.kind == "correct":
            return [(r.name, r.codes) for r in self.reads]
        return list(self.draft.items())

    def sequences(self) -> Dict[str, np.ndarray]:
        """Every sequence the job reads, by name (contigs first)."""
        out = dict(self.draft or {})
        out.update((r.name, r.codes) for r in self.reads)
        return out

    def truth(self, name: str) -> np.ndarray:
        """The true sequence of a query, in its own orientation."""
        if self.kind == "polish":
            return self.truth_contigs[name]
        r = self._by_name[name]
        t = self.genome[r.g_beg: r.g_end]
        return simulate.revcomp(t) if r.reverse else t

    def __post_init__(self):
        self._by_name = {r.name: r for r in self.reads}


def make_inputs(kind: str, params: dict, seed: int) -> Inputs:
    if kind not in ("correct", "polish"):
        raise ValueError(f"unknown job kind {kind!r}")
    rng = np.random.default_rng(seed)
    r = params["reads"]
    g = simulate.genome(rng, int(params["genome_len"]))
    reads = simulate.simulate_reads(
        rng, g, float(r["coverage"]), int(r["read_len"]),
        tuple(r["len_spread"]), float(r["error_rate"]),
        float(r["frac_sub"]), float(r["frac_ins"]), float(r["reverse_frac"]))
    if kind == "correct":
        return Inputs(kind, g, reads)
    c = params.get("contigs")
    if c is None:
        raise ValueError("a polishing traffic needs a 'contigs' section")
    truth, draft = simulate.cut_contigs(
        rng, g, int(c["n"]), int(c["min_len"]), float(c["draft_error"]),
        float(r["frac_sub"]), float(r["frac_ins"]))
    return Inputs(kind, g, reads, draft=draft, truth_contigs=truth)
