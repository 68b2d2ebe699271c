"""The stitch's local-alignment spans in NumPy.

The same arithmetic as frozen/align.py's `posterior_summary` (the plain
version of the full-width kernel) for the stitch's scoring: full width,
exact gaps.  The forward fill keeps each row's match-entering scores;
the backward fill marks the cells on an optimal path; `summary_spans`'
bounding box follows.  Only the outputs the spans need are kept (matched
columns and their first and last rows).  Scores are int32 here and
int16 there, which the plain version never overflows (they stay below
2^14, as its NEG says), so the two agree exactly; a test holds them
equal.  NumPy's small-array calls cost a tenth of PyTorch's, which makes
the reference's stitch of a long contig, one window a round, take
seconds instead of minutes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -(2 ** 14)


def _excl_prefix_max(x: np.ndarray) -> np.ndarray:
    out = np.full_like(x, NEG)
    out[:, 1:] = np.maximum.accumulate(x, axis=1)[:, :-1]
    return out


def spans(q: np.ndarray, q_len: np.ndarray, r: np.ndarray,
          r_len: np.ndarray, match: int, mismatch: int, gap_open: int,
          gap_extend: int) -> Tuple[np.ndarray, ...]:
    """(q_begin, q_end, r_begin, r_end, valid) of each lane's optimal
    local alignment, as summary_spans(posterior_summary(...)) gives
    them; q [N, Lq] and r [N, Lr] codes, lengths [N]."""
    N, Lq = q.shape
    Lr = r.shape[1]
    q_len = q_len.astype(np.int64)
    r_len = r_len.astype(np.int64)
    cols = np.arange(Lr)
    ref_mask = cols[None, :] < r_len[:, None]
    jcost = cols[None, :] * gap_extend
    oe = gap_open - gap_extend
    rows = min(Lq, int(q_len.max())) if N else 0
    qi = q.astype(np.int32)
    ri = r.astype(np.int32)

    def row_scores(i, valid):
        sub = np.where(qi[:, i: i + 1] == ri, match, mismatch)
        return np.where(valid[:, None] & ref_mask, sub, NEG)

    hm_all = np.empty((max(rows, 1), N, Lr), np.int32)
    h = np.zeros((N, Lr), np.int32)
    f = np.full((N, Lr), NEG, np.int32)
    h_diag = np.zeros((N, Lr), np.int32)
    for i in range(rows):
        valid = i < q_len
        sub = row_scores(i, valid)
        h_diag[:, 1:] = h[:, :-1]
        hm = h_diag + sub
        f_new = np.maximum(h - gap_open, f - gap_extend)
        ht = np.maximum(np.maximum(hm, f_new), 0)
        e = _excl_prefix_max(ht + jcost) - jcost - oe
        h_new = np.maximum(ht, e)
        vr = valid[:, None]
        h = np.where(vr, h_new, h)
        f = np.where(vr, f_new, f)
        hm_all[i] = hm
    opt = (np.maximum(hm_all[:rows].max(axis=(0, 2)), 0) if rows
           else np.zeros(N, np.int32))
    pos_opt = (opt > 0)[:, None]
    bh = np.zeros((N, Lr), np.int32)
    bf = np.full((N, Lr), NEG, np.int32)
    matched = np.zeros((N, Lr), bool)
    i_first = np.full((N, Lr), Lq, np.int64)
    i_last = np.full((N, Lr), -1, np.int64)
    bh_diag = np.zeros((N, Lr), np.int32)
    for i in range(rows - 1, -1, -1):
        valid = i < q_len
        sub = row_scores(i, valid)
        bh_diag[:, :-1] = bh[:, 1:]
        bm = sub + bh_diag
        bf_new = np.maximum(bh - gap_open, bf - gap_extend)
        bt = np.maximum(np.maximum(bm, bf_new), 0)
        be = _excl_prefix_max((bt - jcost)[:, ::-1])[:, ::-1] + jcost - oe
        bh_new = np.maximum(bt, be)
        hm_row = hm_all[i]
        on_path = (((hm_row + bh_diag) == opt[:, None])
                   & (hm_row > NEG // 2) & pos_opt)
        vr = valid[:, None]
        bh = np.where(vr, bh_new, bh)
        bf = np.where(vr, bf_new, bf)
        i_first = np.where(on_path, i, i_first)
        i_last = np.where(on_path & ~matched, i, i_last)
        matched |= on_path
    any_match = matched.any(axis=1)
    big = Lr + 10
    rj = cols[None, :]
    r_begin = np.where(matched, rj, big).min(axis=1)
    r_end = np.where(matched, rj, -1).max(axis=1)
    q_begin = np.where(matched, i_first, big + Lr).min(axis=1)
    q_end = np.where(matched, i_last, -1).max(axis=1)
    return (np.where(any_match, q_begin, 0), np.where(any_match, q_end, -1),
            np.where(any_match, r_begin, 0), np.where(any_match, r_end, -1),
            any_match)
