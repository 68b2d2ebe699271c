"""Batched identity against the truth: `metrics.identity` of
`consent_tpu_torch/testing/metrics.py`, many pairs at once.

That function is 1 - d / max(len(a), len(b)), with d the Levenshtein
distance inside a diagonal band of max(256, |len(a) - len(b)| + 2),
filled row by row in a Python loop (a 39 kb contig takes seconds).
Here d comes from the same banded distance computed by diagonals
(Landau and Vishkin): for d = 0, 1, ... the furthest row each diagonal
of the band reaches with d edits, every pair of a batch in one tensor,
until each pair's last cell is reached.  Work grows with the edits, not
the lengths, and the result is the same number (tests hold the two
equal).  Runs on any torch device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

SHORT = 8           # bases every live diagonal compares per slide
CHUNK = 64          # bases compared at a time on a diagonal still equal


def _slide(fr, A, B, la, lb, ks, live):
    """Advance each live diagonal's row over equal bases
    (a[i] == b[i + k]): SHORT bases on every one, then CHUNK at a time
    on the few still running (off the optimal path a run is ~1 base)."""
    P, K = fr.shape
    dev = fr.device
    i = fr[..., None] + torch.arange(SHORT, device=dev)          # [P, K, S]
    j = i + ks[None, :, None]
    ok = (i < la[:, None, None]) & (j < lb[:, None, None]) & (j >= 0)
    ai = torch.gather(A, 1, i.clamp(0, A.shape[1] - 1).reshape(P, -1))
    bj = torch.gather(B, 1, j.clamp(0, B.shape[1] - 1).reshape(P, -1))
    eq = (ai == bj).reshape(P, K, SHORT) & ok & live[..., None]
    run = torch.cumprod(eq.to(torch.int32), dim=2).sum(dim=2)
    fr = fr + run
    pi, ki = (run == SHORT).nonzero(as_tuple=True)
    step = torch.arange(CHUNK, device=dev)
    while len(pi):
        i = fr[pi, ki][:, None] + step                           # [M, C]
        j = i + ks[ki][:, None]
        ok = (i < la[pi][:, None]) & (j < lb[pi][:, None]) & (j >= 0)
        ai = A[pi[:, None], i.clamp(0, A.shape[1] - 1)]
        bj = B[pi[:, None], j.clamp(0, B.shape[1] - 1)]
        run = torch.cumprod(((ai == bj) & ok).to(torch.int32), dim=1).sum(1)
        fr[pi, ki] += run
        keep = run == CHUNK
        pi, ki = pi[keep], ki[keep]
    return fr


def _row_distances(A, B, la, lb, bands, INF=1 << 28):
    """The same distances by metrics.edit_distance_banded's own row-by-row
    fill, every pair at once (for the few pairs whose edits are many
    against their length, where a row costs less than an edit)."""
    P = len(la)
    dev = A.device
    K = int(bands.max())
    offs = torch.arange(-K, K + 1, device=dev)[None, :]
    inband = offs.abs() <= bands[:, None]
    lam, lbm = la[:, None], lb[:, None]
    ok0 = (offs >= 0) & (offs <= lbm) & inband
    prev = torch.where(ok0, offs, INF)
    for i in range(1, int(la.max()) + 1):
        j = i + offs
        valid = (j >= 0) & (j <= lbm) & inband
        jm1 = j - 1
        okd = valid & (jm1 >= 0)
        bj = torch.gather(B, 1, jm1.clamp(0, B.shape[1] - 1).expand(P, -1))
        sub = (A[:, i - 1: i] != bj).to(prev.dtype)
        diag = torch.where(okd, prev + sub, INF)
        up = torch.full_like(prev, INF)
        up[:, :-1] = prev[:, 1:] + 1
        up = torch.where(valid, up, INF)
        cur_nl = torch.minimum(diag, up)
        m = torch.cummin(cur_nl - j, dim=1).values
        left = torch.full_like(prev, INF)
        left[:, 1:] = m[:, :-1] + j[:, 1:]
        cur = torch.minimum(cur_nl, torch.where(valid, left, INF))
        cur = torch.where(valid, cur, INF)
        prev = torch.where(i <= lam, cur, prev)
    return prev.gather(1, (lb - la + K)[:, None])[:, 0]


def edit_distances(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                   band: int = 256, device="cpu") -> List[int]:
    """The banded Levenshtein distance of each (a, b), as
    metrics.edit_distance_banded computes it (both non-empty).  Edits are
    counted one at a time up to a sixteenth of the longest sequence; the
    pairs still open then are filled row by row."""
    n = len(pairs)
    if n == 0:
        return []
    dev = torch.device(device)
    la_np = np.array([len(a) for a, _ in pairs], dtype=np.int64)
    lb_np = np.array([len(b) for _, b in pairs], dtype=np.int64)
    if (la_np == 0).any() or (lb_np == 0).any():
        raise ValueError("edit_distances takes non-empty sequences")
    bands = np.maximum(band, np.abs(la_np - lb_np) + 2)
    K = int(bands.max())
    A = np.full((n, int(la_np.max())), 4, dtype=np.uint8)
    B = np.full((n, int(lb_np.max())), 5, dtype=np.uint8)
    for p, (a, b) in enumerate(pairs):
        A[p, : len(a)] = a
        B[p, : len(b)] = b
    A = torch.from_numpy(A).to(dev)
    B = torch.from_numpy(B).to(dev)
    la = torch.from_numpy(la_np).to(dev)
    lb = torch.from_numpy(lb_np).to(dev)
    bnd = torch.from_numpy(bands).to(dev)
    ks = torch.arange(-K, K + 1, device=dev)                     # diagonals
    in_band = ks[None, :].abs() <= bnd[:, None]                  # [P, K']
    NEG = -(1 << 40)
    fr = torch.full((n, 2 * K + 1), NEG, dtype=torch.int64, device=dev)
    fr[:, K] = 0
    fr = _slide(fr, A, B, la, lb, ks, fr >= 0)
    k_end = (lb - la + K)[:, None]                               # column
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    cap = max(64, max(int(la_np.max()), int(lb_np.max())) // 16)
    d = 0
    while True:
        done = fr.gather(1, k_end)[:, 0] >= la
        if bool(done.any()):
            out[idx[done]] = d
            keep = ~done
            if not bool(keep.any()):
                break
            fr, A, B, la, lb = fr[keep], A[keep], B[keep], la[keep], lb[keep]
            in_band, k_end, idx = in_band[keep], k_end[keep], idx[keep]
        if d == cap:
            bnd = torch.maximum(torch.full_like(la, band), (la - lb).abs() + 2)
            out[idx] = _row_distances(A, B, la, lb, bnd)
            break
        d += 1
        # one more edit: substitution (same diagonal, next row),
        # a base of a alone (from diagonal k + 1, next row), a base of b
        # alone (from diagonal k - 1, same row)
        sub = fr + 1
        from_up = torch.full_like(fr, NEG)
        from_up[:, :-1] = fr[:, 1:] + 1
        from_left = torch.full_like(fr, NEG)
        from_left[:, 1:] = fr[:, :-1]
        new = torch.maximum(torch.maximum(sub, from_up), from_left)
        new = torch.minimum(new, torch.minimum(la[:, None],
                                               lb[:, None] - ks[None, :]))
        ok = in_band & (new >= -ks[None, :]) & (new >= 0) & (new > NEG // 2)
        fr = torch.where(ok, new, NEG)
        fr = _slide(fr, A, B, la, lb, ks, ok)
    return out.cpu().tolist()


def identities(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
               band: int = 256, device="cpu",
               batch: int = 4096) -> List[float]:
    """metrics.identity of each (test, truth): 0 when either is empty,
    else 1 - d / max(len).  Pairs go in batches of similar length."""
    out = [0.0] * len(pairs)
    todo = [i for i, (a, b) in enumerate(pairs) if len(a) and len(b)]
    todo.sort(key=lambda i: len(pairs[i][1]))
    for lo in range(0, len(todo), batch):
        part = todo[lo: lo + batch]
        ds = edit_distances([pairs[i] for i in part], band, device)
        for i, dist in zip(part, ds):
            a, b = pairs[i]
            out[i] = 1.0 - dist / max(len(a), len(b))
    return out
