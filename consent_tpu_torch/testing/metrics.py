"""Sequence identity metrics (banded Levenshtein, vectorized NumPy)."""

from __future__ import annotations

import numpy as np


def edit_distance_banded(a: np.ndarray, b: np.ndarray,
                         band: int = 256) -> int:
    """Levenshtein distance within a diagonal band (exact when the true
    distance fits in the band; an upper bound otherwise)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    band = max(band, abs(la - lb) + 2)
    INF = la + lb + 10
    # row i: dp over j in [i - band, i + band]
    width = 2 * band + 1
    prev = np.full(width, INF, dtype=np.int64)
    # row 0: dp[0][j] = j for j in [max(0, -band) .. band]
    offs = np.arange(-band, band + 1)
    j0 = offs  # j values at row 0
    valid0 = (j0 >= 0) & (j0 <= lb)
    prev[valid0] = j0[valid0]
    for i in range(1, la + 1):
        j = i + offs
        valid = (j >= 0) & (j <= lb)
        cur = np.full(width, INF, dtype=np.int64)
        # diag: dp[i-1][j-1] is at same offset in prev
        jm1 = j - 1
        okd = valid & (jm1 >= 0)
        sub = np.ones(width, dtype=np.int64)
        jj = np.clip(jm1, 0, lb - 1)
        sub[okd] = (a[i - 1] != b[jj[okd]]).astype(np.int64)
        diag = np.where(okd, prev + sub, INF)
        # up: dp[i-1][j] at offset+1 in prev
        up = np.full(width, INF, dtype=np.int64)
        up[:-1] = prev[1:] + 1
        up = np.where(valid, up, INF)
        # left: dp[i][j-1] at offset-1 in cur — sequential; resolve with
        # a prefix-min scan: left[j] = min_k<j (cur_nl[k] + (j-k))
        cur_nl = np.minimum(diag, up)
        m = np.minimum.accumulate(cur_nl - j)
        left = np.empty(width, dtype=np.int64)
        left[0] = INF
        left[1:] = m[:-1] + j[1:]
        cur = np.minimum(cur_nl, np.where(valid, left, INF))
        cur[~valid] = INF
        prev = cur
    off_end = lb - la + band
    return int(prev[off_end])


def identity(a: np.ndarray, b: np.ndarray, band: int = 256) -> float:
    """1 - edits / max(len) — alignment identity proxy."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    d = edit_distance_banded(a, b, band)
    return 1.0 - d / max(len(a), len(b))


def error_profile(a: np.ndarray, b: np.ndarray, band: int = 256,
                  free_truth_ends: bool = False) -> dict:
    """Per-error-type counts of an optimal banded global alignment of
    `a` (test) vs `b` (truth): substitutions, insertions (bases in `a`
    absent from `b`), deletions (truth bases missing from `a`) — the
    ELECTOR-style breakdown the CONSENT paper evaluates with.

    free_truth_ends=True scores semi-globally: truth overhangs at
    either end are free (the right mode for TRIMMED reads, where the
    corrector intentionally cut weak ends — counting those as
    deletions would charge the trim as errors).

    Returns {n_sub, n_ins, n_del, n_match, identity}.  Identity here is
    matches / alignment columns."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return {"n_sub": 0, "n_ins": la, "n_del": lb, "n_match": 0,
                "identity": 0.0}
    band = max(band, abs(la - lb) + 2)
    width = 2 * band + 1
    INF = la + lb + 10
    offs = np.arange(-band, band + 1)
    dp = np.full((la + 1, width), INF, dtype=np.int32)
    j0 = offs
    ok0 = (j0 >= 0) & (j0 <= lb)
    dp[0, ok0] = 0 if free_truth_ends else j0[ok0]
    for i in range(1, la + 1):
        j = i + offs
        valid = (j >= 0) & (j <= lb)
        jm1 = j - 1
        okd = valid & (jm1 >= 0)
        jj = np.clip(jm1, 0, lb - 1)
        sub = np.where(a[i - 1] != b[jj], 1, 0)
        diag = np.where(okd, dp[i - 1] + sub, INF)
        up = np.full(width, INF, np.int32)
        up[:-1] = dp[i - 1, 1:] + 1           # insertion in a
        up = np.where(valid, up, INF)
        cur_nl = np.minimum(diag, up)
        m = np.minimum.accumulate(cur_nl - j)
        left = np.empty(width, np.int32)
        left[0] = INF
        left[1:] = m[:-1] + j[1:]             # deletion run
        dp[i] = np.minimum(cur_nl, np.where(valid, left, INF))
        dp[i, ~valid] = INF
    # traceback
    i, j = la, lb
    if free_truth_ends:
        # end anywhere on the last row (free trailing truth overhang)
        jj_all = la + offs
        okl = (jj_all >= 0) & (jj_all <= lb)
        best = int(np.argmin(np.where(okl, dp[la], INF)))
        j = int(la + offs[best])
    n_sub = n_ins = n_del = n_match = 0
    while i > 0 or j > 0:
        if free_truth_ends and i == 0:
            break  # leading truth overhang is free
        o = j - i + band
        cur = dp[i, o]
        if i > 0 and j > 0 and 0 <= o < width:
            s = int(a[i - 1] != b[j - 1])
            if dp[i - 1, o] == cur - s:
                n_sub += s
                n_match += 1 - s
                i -= 1
                j -= 1
                continue
        if i > 0 and o + 1 < width and dp[i - 1, o + 1] == cur - 1:
            n_ins += 1
            i -= 1
            continue
        if j > 0 and o - 1 >= 0 and dp[i, o - 1] == cur - 1:
            n_del += 1
            j -= 1
            continue
        # numerical dead end (shouldn't happen): bail conservatively
        if i > 0:
            n_ins += 1
            i -= 1
        else:
            n_del += 1
            j -= 1
    cols = n_sub + n_ins + n_del + n_match
    return {
        "n_sub": n_sub, "n_ins": n_ins, "n_del": n_del,
        "n_match": n_match,
        "identity": n_match / cols if cols else 0.0,
    }
