"""Read-level post-processing: trim and drop.

Mirrors the reference utils (src/utils.cpp:71-128) on the
(codes, solid) representation."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def trim_read(codes: np.ndarray, solid: np.ndarray, n: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Trim to the span between the first and last run of >= n solid
    bases (reference trimRead, src/utils.cpp:96-128; called with n=1 by
    the correction driver, CONSENT-correction.cpp:51).  Returns empty
    arrays when nothing solid remains (the reference's "" result; its
    behavior on an all-weak read is undefined — unsigned wraparound —
    we return empty)."""
    solid = np.asarray(solid, dtype=bool)
    idx = np.flatnonzero(solid)
    if len(idx) == 0:
        return codes[:0], solid[:0]
    if n == 1:
        beg, end = int(idx[0]), int(idx[-1])
    else:
        # first/last position where a run of n solid bases completes
        run = np.convolve(solid.astype(np.int64), np.ones(n, dtype=np.int64),
                          mode="valid")
        full = np.flatnonzero(run == n)
        if len(full) == 0:
            return codes[:0], solid[:0]
        beg = int(full[0])
        end = int(full[-1]) + n - 1
    if end > beg:
        return codes[beg : end + 1], solid[beg : end + 1]
    return codes[:0], solid[:0]


def drop_read(solid: np.ndarray) -> bool:
    """True if fewer than 10% of bases are solid (reference dropRead,
    src/utils.cpp:71-73)."""
    if len(solid) == 0:
        return True
    return float(np.count_nonzero(solid)) / len(solid) < 0.1


def split_read(codes: np.ndarray, solid: np.ndarray, window_size: int
               ) -> list:
    """Split at uncorrected gaps of >= window_size bases (reference
    splitRead, src/utils.cpp:130-164 — declared but never called by the
    v2.2 drivers; provided for parity/completeness).  Returns a list of
    (codes, solid) pieces.

    Exact-parity quirks mirrored (fuzz-diffed against the compiled
    reference in tests/test_reference_diff.py):
      * the trailing tail scan starts at s[length] ('\\0', not upper)
        and the final piece is substr(prev, i - prev), so the LAST
        SOLID BASE IS ALWAYS EXCLUDED from the final piece
        (utils.cpp:157-161),
      * an all-weak read yields one empty piece, not zero pieces,
      * pilesPos / windowOverlap params of the reference are unused
        there and therefore not taken here."""
    solid = np.asarray(solid, dtype=bool)
    L = len(codes)
    i = 0
    while i < L and not solid[i]:
        i += 1
    prev = i
    nb = 0
    pieces = []
    while i < L:
        if not solid[i]:
            nb += 1
        else:
            if nb >= window_size:
                pieces.append((codes[prev : i - nb], solid[prev : i - nb]))
                prev = i
            nb = 0
        i += 1
    # tail: i == L; s[L] reads as '\0' (not uppercase) in the reference
    while i > 0 and (i >= L or not solid[i]):
        i -= 1
    end = max(i, prev)
    pieces.append((codes[prev:end], solid[prev:end]))
    return pieces
