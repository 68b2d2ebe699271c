"""PAF parsing, reformatting, and pile streaming.

Semantics mirrored from the reference:
  * 12-column PAF; qEnd/tEnd are stored INCLUSIVE (minimap2 reports the
    position one past the last match, so both get -1; reference:
    src/Overlap.h:39,49),
  * strand True means '-' (src/Overlap.h:41),
  * a pile = consecutive PAF lines sharing qName (the PAF must be
    query-grouped; src/alignmentPiles.cpp:22-58), sorted descending by
    residue matches and truncated to maxSupport (:41-44),
  * reformat swaps query and target column groups, keeping the strand
    column — used by polishing so the contig becomes the query
    (src/reformatPAF.cpp:22-33).

Overlaps are held in a numpy structured array; names are kept in
side lists (object arrays) since they're only used for index lookups.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# Numeric columns of an overlap record.  Names follow the reference's
# struct Overlap (src/Overlap.h:8-20).
OVERLAP_DTYPE = np.dtype(
    [
        ("q_len", np.int64),
        ("q_start", np.int64),
        ("q_end", np.int64),        # inclusive
        ("strand", np.bool_),       # True == '-'
        ("t_len", np.int64),
        ("t_start", np.int64),
        ("t_end", np.int64),        # inclusive
        ("matches", np.int64),
        ("block_len", np.int64),
        ("mapq", np.int64),
    ]
)


@dataclasses.dataclass
class Pile:
    """All overlaps of one query (read or contig)."""

    q_name: str
    t_names: List[str]              # parallel to rows of `ov`
    ov: np.ndarray                  # structured array, OVERLAP_DTYPE

    def __len__(self) -> int:
        return len(self.ov)

    @property
    def q_len(self) -> int:
        return int(self.ov["q_len"][0])

