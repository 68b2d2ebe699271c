"""Reverse complement.

Sequences live as numpy uint8 code arrays: A=0, C=1, G=2, T/other=3 —
the same 2-bit alphabet the reference packs into vector<bool>
(reference: src/utils.cpp:21-54 fullstr2num/fullnum2str, where any
non-ACGT byte encodes as T).  The "case channel" the reference threads
through ASCII case (solid vs weak bases, reference:
src/correctionMSA.cpp:6-27) is carried here as a separate uint8 mask —
case is only materialized when writing FASTA.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3

# code -> complement code (A<->T, C<->G).
_COMP = np.array([T, G, C, A], dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement on code arrays (reference:
    src/reverseComplement.cpp:6-23, minus the ASCII-case bookkeeping —
    case travels separately here)."""
    return _COMP[codes[::-1]]


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling 2-bit k-mer integers of a code array: length n-k+1.

    kmer[i] = sum_j codes[i+j] * 4^(k-1-j), identical numbering to the
    reference's str2num (BMEAN/utils.h, consumed by src/DBG.cpp:30).
    """
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.int64)
    weights = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(
        codes.astype(np.int64), k
    )
    return windows @ weights

