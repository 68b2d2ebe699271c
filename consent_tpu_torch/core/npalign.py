"""Host-side affine-gap local aligner (NumPy, with traceback).

Serves two roles:
  * the test oracle for the TPU posterior aligner (ops/align.py),
  * the aligner for rare, tiny host-side alignments in the stitcher's
    overlap arbitration (reference: src/correctionAlignment.cpp:110),
    where batching to the device isn't worth the round trip.

Same scoring semantics as ops/align.py: gap of length g costs
open + (g-1)*ext; local (Smith-Waterman) with zero floor.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

NEG = -(2 ** 20)


class NpAlignment(NamedTuple):
    opt: int
    q_begin: int
    q_end: int       # inclusive; -1 if empty
    r_begin: int
    r_end: int
    pairs: List[Tuple[int, int]]   # matched (i, j) pairs on the traceback
    n_ins: int       # query bases inside the alignment not matched (I ops)
    n_del: int       # ref bases inside the alignment not matched (D ops)


def local_align(
    q: np.ndarray,
    r: np.ndarray,
    match: int = 2,
    mismatch: int = -4,
    gap_open: int = 4,
    gap_extend: int = 2,
) -> NpAlignment:
    Lq, Lr = len(q), len(r)
    H = np.zeros((Lq + 1, Lr + 1), dtype=np.int64)
    E = np.full((Lq + 1, Lr + 1), NEG, dtype=np.int64)  # horizontal (ref gap)
    F = np.full((Lq + 1, Lr + 1), NEG, dtype=np.int64)  # vertical (query gap)

    for i in range(1, Lq + 1):
        for j in range(1, Lr + 1):
            E[i][j] = max(H[i][j - 1] - gap_open, E[i][j - 1] - gap_extend)
            F[i][j] = max(H[i - 1][j] - gap_open, F[i - 1][j] - gap_extend)
            sub = match if q[i - 1] == r[j - 1] else mismatch
            H[i][j] = max(0, H[i - 1][j - 1] + sub, E[i][j], F[i][j])

    opt = int(H.max())
    if opt == 0:
        return NpAlignment(0, 0, -1, 0, -1, [], 0, 0)
    i, j = np.unravel_index(np.argmax(H), H.shape)
    i, j = int(i), int(j)

    pairs: List[Tuple[int, int]] = []
    n_ins = n_del = 0
    state = "H"
    while H[i][j] > 0 or state != "H":
        if state == "H":
            sub = match if q[i - 1] == r[j - 1] else mismatch
            if H[i][j] == H[i - 1][j - 1] + sub:
                pairs.append((i - 1, j - 1))
                i, j = i - 1, j - 1
            elif H[i][j] == E[i][j]:
                state = "E"
            elif H[i][j] == F[i][j]:
                state = "F"
            else:
                break  # H == 0: local start
        elif state == "E":
            n_del += 1
            if E[i][j] == E[i][j - 1] - gap_extend:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:  # F
            n_ins += 1
            if F[i][j] == F[i - 1][j] - gap_extend:
                i -= 1
            else:
                i -= 1
                state = "H"

    pairs.reverse()
    return NpAlignment(
        opt=opt,
        q_begin=pairs[0][0],
        q_end=pairs[-1][0],
        r_begin=pairs[0][1],
        r_end=pairs[-1][1],
        pairs=pairs,
        n_ins=n_ins,
        n_del=n_del,
    )
