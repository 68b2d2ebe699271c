"""Sparse per-window k-mer count tables for the stitcher.

A dense 4^9 table per window is fine transiently (weighting + DBG
polish) but a contig has thousands of windows whose counts the stitcher
probes later (reference keeps a hash map per window,
CONSENT-polishing.cpp:32).  SparseCounts compresses a dense table to
the (sorted kmer, count) pairs actually present."""

from __future__ import annotations

import numpy as np


class SparseCounts:
    __slots__ = ("kmers", "counts")

    def __init__(self, kmers: np.ndarray, counts: np.ndarray):
        self.kmers = kmers          # sorted int64
        self.counts = counts        # int32, parallel

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "SparseCounts":
        kmers = np.flatnonzero(dense).astype(np.int64)
        return cls(kmers, dense[kmers].astype(np.int32))

    def get_many(self, kmers: np.ndarray) -> np.ndarray:
        """Counts for an int64 k-mer array (0 where absent)."""
        if len(self.kmers) == 0 or len(kmers) == 0:
            return np.zeros(len(kmers), dtype=np.int32)
        pos = np.searchsorted(self.kmers, kmers)
        pos = np.clip(pos, 0, len(self.kmers) - 1)
        hit = self.kmers[pos] == kmers
        out = np.where(hit, self.counts[pos], 0)
        return out.astype(np.int32)

    def n_solid(self, kmers: np.ndarray, solid_thresh: int) -> int:
        return int(np.count_nonzero(self.get_many(kmers) >= solid_thresh))
