"""Stitch per-window consensuses back onto the raw read/contig.

Faithful reimplementation of the reference's alignConsensus
(src/correctionAlignment.cpp:47-140): the raw sequence starts all-weak
(lowercase); window consensuses are locally aligned, in window order,
against a slab of the *evolving* sequence around the expected position;
overlaps with the previously spliced window are arbitrated by solid
k-mer counts; the winning bases are spliced in as solid (uppercase).

The window-to-window dependency makes one read's stitch inherently
sequential (the slab includes previously spliced bases), so the TPU
batching axis is *across reads*: a StitchScheduler runs many reads in
lockstep, collecting each read's next (consensus, slab) pair into one
batched device alignment per round (SURVEY.md §3.2).

Alignment scoring mirrors the reference's SSW defaults
(match=2, mismatch=-2, gap_open=3, gap_extend=1;
StripedSmithWaterman::Aligner's default constructor,
src/correctionAlignment.cpp:48).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .config import ConsentConfig
from . import npalign
from .sparse_counts import SparseCounts
from . import seqs

STITCH_SCORING = dict(match=2, mismatch=-2, gap_open=3, gap_extend=1)


@dataclasses.dataclass
class AlignSpan:
    """What the stitcher needs from one consensus-vs-slab alignment."""

    q_begin: int
    q_end: int     # inclusive; -1 when no alignment
    r_begin: int
    r_end: int
    valid: bool


class StitchJob:
    """Sequential stitch state of one read/contig.

    consensuses: list of (codes, solid) per window (post DBG polish);
    templates: list of raw template fragments (window's pile[0]);
    counts: list of SparseCounts per window.
    """

    def __init__(
        self,
        name: str,
        raw_codes: np.ndarray,
        piles_pos: Sequence[Tuple[int, int]],
        consensuses: Sequence[Tuple[np.ndarray, np.ndarray]],
        templates: Sequence[np.ndarray],
        counts: Sequence[SparseCounts],
        cfg: ConsentConfig,
    ):
        self.name = name
        self.cfg = cfg
        self.piles_pos = list(piles_pos)
        self.consensuses = list(consensuses)
        self.templates = list(templates)
        self.counts = list(counts)

        self.out_c = np.asarray(raw_codes, dtype=np.uint8).copy()
        self.out_s = np.zeros(len(self.out_c), dtype=bool)  # all-lowercase
        self.i = 0
        self.cur_pos = int(piles_pos[0][0]) if piles_pos else 0
        self.old_end = 0
        self.old_cons: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.old_mers: Optional[SparseCounts] = None
        # per-window transients between request and apply
        self._cur_cons: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._al_pos = 0

    @property
    def done(self) -> bool:
        return self.i >= len(self.consensuses)

    def next_request(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(query, ref) for this read's next window alignment."""
        if self.done:
            return None
        cfg = self.cfg
        cons_c, cons_s = self.consensuses[self.i]
        if len(cons_c) < cfg.mer_size:
            # fall back to the raw template fragment, all-solid (the
            # reference's templates[] strings are uppercase,
            # correctionAlignment.cpp:75-77)
            tpl = self.templates[self.i]
            cons_c, cons_s = tpl, np.ones(len(tpl), dtype=bool)
        self._cur_cons = (cons_c, cons_s)

        al_pos = max(0, self.cur_pos - cfg.window_overlap)
        size_al = cfg.window_size + 2 * cfg.window_overlap
        if al_pos + size_al >= len(self.out_c):
            size_al = len(self.out_c) - al_pos
        self._al_pos = al_pos
        return cons_c, self.out_c[al_pos : al_pos + size_al]

    def apply(self, span: AlignSpan) -> None:
        """Consume the alignment of the current window and advance."""
        cfg = self.cfg
        k = cfg.mer_size
        i = self.i
        cons_c, cons_s = self._cur_cons
        raw_cons_len = len(self.consensuses[i][0])

        if not span.valid:
            # no local alignment at all: skip this window entirely
            # (SSW can't return an empty alignment for our inputs in
            # practice; guard anyway)
            self.i += 1
            return

        beg = span.r_begin + self._al_pos
        end = span.r_end + self._al_pos
        cur_c = cons_c[span.q_begin : span.q_end + 1]
        cur_s = cons_s[span.q_begin : span.q_end + 1]

        # ---- overlap arbitration with the previous window ----
        if i != 0 and self.old_end >= beg and self.old_cons is not None:
            overlap = self.old_end - beg + 1
            old_c, old_s = self.old_cons
            if (
                raw_cons_len >= k
                and len(old_c) >= overlap
                and len(cur_c) >= overlap
            ):
                seq1_c = old_c[len(old_c) - overlap :]
                seq1_s = old_s[len(old_s) - overlap :]
                seq2_c = cur_c[:overlap]
                seq2_s = cur_s[:overlap]
                if not np.array_equal(seq1_c, seq2_c):
                    if overlap >= k:
                        sm1 = self.old_mers.n_solid(
                            seqs.kmer_codes(seq1_c, k), cfg.solid_thresh
                        )
                        sm2 = self.counts[i].n_solid(
                            seqs.kmer_codes(seq2_c, k), cfg.solid_thresh
                        )
                    else:
                        sm1 = int(np.count_nonzero(seq1_s))
                        sm2 = int(np.count_nonzero(seq2_s))
                    if sm1 > sm2:
                        # keep the previous window's version of the
                        # overlap; the reference clamps the ref side of
                        # this sub-alignment to min(len1, len2)
                        # (correctionAlignment.cpp:110) — both are
                        # `overlap` long here, but mirror it exactly
                        ref_len = min(len(seq1_c), len(seq2_c))
                        sub = npalign.local_align(
                            seq1_c, seq2_c[:ref_len], **STITCH_SCORING
                        )
                        cut = overlap - sub.n_ins + sub.n_del
                        if cut < len(cur_c):
                            cur_c = np.concatenate([seq1_c, cur_c[cut:]])
                            cur_s = np.concatenate([seq1_s, cur_s[cut:]])
                        else:
                            cur_c = cur_c[:0]
                            cur_s = cur_s[:0]

        # ---- splice ----
        if len(cur_c) != 0:
            if raw_cons_len >= k:
                self.out_c = np.concatenate(
                    [self.out_c[:beg], cur_c, self.out_c[end + 1 :]]
                )
                self.out_s = np.concatenate(
                    [
                        self.out_s[:beg],
                        np.ones(len(cur_c), dtype=bool),
                        self.out_s[end + 1 :],
                    ]
                )
            if i < len(self.consensuses) - 1:
                self.cur_pos = (
                    self.cur_pos
                    + self.piles_pos[i + 1][0]
                    - self.piles_pos[i][0]
                    - (end - beg + 1)
                    + len(cur_c)
                )
                self.old_cons = (cur_c, cur_s)
                self.old_mers = self.counts[i]
                self.old_end = beg + len(cur_c) - 1

        self.i += 1

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.out_c, self.out_s
