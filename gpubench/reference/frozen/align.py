"""Batched affine-gap local alignment, traceback-free (PyTorch).

The plain PyTorch version of both posterior-alignment kernels
(ops/cuda_align.py): banded when `sc.band > 0`, full width otherwise.
It runs on CPU or CUDA tensors and is the oracle the kernels are held
against, bit for bit.

Instead of a traceback, we compute the *match posterior*: a cell (i, j)
lies on an optimal local alignment with (i ~ j) matched iff

    fwd_match(i,j) + bwd_cont(i+1,j+1) == opt

where fwd_match is the best score of a local path ending with (i~j)
aligned and bwd_cont is the best (possibly empty) continuation starting
at (i+1, j+1).  Affine gaps cannot straddle a matched pair, so the
split is exact.  The posterior is never materialized as a [Lq, Lr]
tensor: the backward scan folds each row into per-column summaries
(matched?, first/last matched query row), which is all that consensus
voting and span extraction need.

Gap cost model: a gap of length g costs open + (g-1)*ext, matching the
SSW library's semantics used by the reference stitcher.

Within-row recurrence (the standard two-pass trick): with
  Ht[i][j] = max(0, H[i-1][j-1] + sub(i,j), F[i][j])     (no E term)
the horizontal state is exactly
  E[i][j]  = max_{k<j} (Ht[i][k] - open - (j-1-k)*ext)
because a horizontal gap run must start from a non-E cell (re-opening
from an E cell is never better since open >= ext > 0).  E is an
exclusive prefix-max of (Ht[i][k] + k*ext), one scan per row.

DP states are int16, as in the JAX package, so wrap-around behaves the
same on both sides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -(2 ** 14)  # effectively -inf; int16-safe (scores stay < 2^14)

I16 = torch.int16
I32 = torch.int32


class Scoring(NamedTuple):
    match: int = 2
    mismatch: int = -4
    gap_open: int = 4     # cost of the first base of a gap
    gap_extend: int = 2   # cost of each further base
    # Maximum horizontal (reference-consuming) gap length the DP scores;
    # 0 = unlimited (exact affine SW).  A cap of 2^k shrinks the per-row
    # prefix-max scan to k steps — the consensus path uses 16; the
    # stitch path stays exact.
    max_hgap: int = 0
    # Diagonal band width (0 = full DP).  With band = B > 0 the DP only
    # fills cells with (j - d0) - i in [-B/2, B/2), where d0 is the
    # per-lane expected ref column of query base 0.  Cells outside the
    # band are -inf.
    band: int = 0
    # Bits of the DP's score type.  16 is the stated precision (scores
    # stay below 2^14); 8 is the harness's control, one type below.
    score_bits: int = 16


INS_PACK = 16  # inserted bases packed 2-bit into one int32 per column


class PosteriorSummary(NamedTuple):
    """Per-column posterior summaries, all [N, Lr] (query-row indices
    are int32; -1/Lq sentinels where unmatched).

      base[j]     = q[i_last[j]]            (the aligned base)
      ins_pack[j] = q[i_last[j]+1 .. +16] packed 2 bits/base, LSB first
    """

    opt: torch.Tensor        # [N] int32 optimal local score
    matched: torch.Tensor    # [N, Lr] bool: column j matched on an optimal path
    i_first: torch.Tensor    # [N, Lr] smallest matched query row (Lq if none)
    i_last: torch.Tensor     # [N, Lr] largest matched query row (-1 if none)
    base: torch.Tensor       # [N, Lr] int32
    ins_pack: torch.Tensor   # [N, Lr] int32


def _prefix_max_exclusive(x: torch.Tensor, max_window: int = 0,
                          neg: int = NEG) -> torch.Tensor:
    """Exclusive running max along the last axis (identity neg).  With
    max_window = G > 0, the max only looks back G entries (capped-gap
    scoring, see Scoring.max_hgap)."""
    L = x.shape[-1]
    if max_window and max_window < L:
        inc = x
        s = 1
        while s < max_window:
            shifted = torch.full_like(inc, neg)
            shifted[..., s:] = inc[..., : L - s]
            inc = torch.maximum(inc, shifted)
            s *= 2
    else:
        inc = torch.cummax(x, dim=-1).values
    out = torch.full_like(inc, neg)
    out[..., 1:] = inc[..., : L - 1]
    return out


def posterior_summary(
    q: torch.Tensor,       # [N, Lq] uint8 codes
    q_len: torch.Tensor,   # [N] int32
    r: torch.Tensor,       # [N, Lr] uint8 codes
    r_len: torch.Tensor,   # [N] int32
    sc: Scoring = Scoring(),
    d0: torch.Tensor | None = None,   # [N] expected ref col of q[0] (band)
) -> PosteriorSummary:
    """Forward + backward local-alignment fill with streaming posterior
    reduction: the plain version of both CUDA kernels (including the
    banded variant's exact clipping semantics when sc.band > 0).

    Lanes are independent, and a lane with an empty query scores no
    cell (opt 0, nothing matched), so only the other lanes are filled —
    the engine's padded batches are mostly empty lanes."""
    N, Lq = q.shape
    Lr = r.shape[1]
    live = (q_len > 0).nonzero().squeeze(1)
    if len(live) == N:
        return _fill(q, q_len, r, r_len, sc, d0)
    dev = q.device
    out = PosteriorSummary(
        opt=torch.zeros((N,), dtype=I32, device=dev),
        matched=torch.zeros((N, Lr), dtype=torch.bool, device=dev),
        i_first=torch.full((N, Lr), Lq, dtype=I32, device=dev),
        i_last=torch.full((N, Lr), -1, dtype=I32, device=dev),
        base=torch.zeros((N, Lr), dtype=I32, device=dev),
        ins_pack=torch.zeros((N, Lr), dtype=I32, device=dev),
    )
    if len(live):
        part = _fill(q[live], q_len[live], r[live], r_len[live], sc,
                     None if d0 is None else d0[live])
        for dst, src in zip(out, part):
            dst[live] = src
    return out


def _fill(q, q_len, r, r_len, sc, d0):
    """posterior_summary over lanes whose queries are not empty.  Rows
    at or past every lane's query end change no state and hold no
    match (their hm is below NEG/2), so the loops stop at the longest
    query."""
    N, Lq = q.shape
    Lr = r.shape[1]
    dev = q.device
    SD = torch.int8 if sc.score_bits == 8 else I16
    NEGD = -(2 ** 6) if SD is torch.int8 else NEG
    qi = q.to(I16)
    ri = r.to(I16)
    q_len = q_len.to(I32)
    r_len = r_len.to(I32)
    cols = torch.arange(Lr, device=dev)
    ref_mask = cols[None, :] < r_len[:, None]                     # [N, Lr]
    open_, ext = sc.gap_open, sc.gap_extend
    jcost = (cols * ext).to(SD)                                    # j*ext

    band = sc.band
    if band:
        OFF = band // 2
        if d0 is None:
            d0 = torch.zeros((N,), dtype=I32, device=dev)
        # Kernel column of true column j.  Row i of the banded kernel
        # materializes only slots chat in [i - OFF, i + band - OFF)
        # (cells outside are -inf: they have no slot), and its ref view
        # is the window chat in [0, Lr) — columns outside that window
        # behave like ordinary out-of-ref cells (score floor 0).
        chat = cols[None, :] - d0.to(I32)[:, None]
        chat_ok = (chat >= 0) & (chat < Lr)

        def in_geom(i):
            rel = chat - i + OFF
            return (rel >= 0) & (rel < band)
    else:
        def in_geom(i):
            return None

    neg16 = torch.tensor(NEGD, dtype=SD, device=dev)
    match16 = torch.tensor(sc.match, dtype=SD, device=dev)
    mismatch16 = torch.tensor(sc.mismatch, dtype=SD, device=dev)

    def row_scores(i, valid_row):
        sub = torch.where(qi[:, i : i + 1] == ri, match16, mismatch16)
        ok = valid_row[:, None] & ref_mask
        if band:
            ok = ok & in_geom(i) & chat_ok
        return torch.where(ok, sub, neg16)

    def band_clip(x, geom):
        """Cells with no slot in row i of the banded kernel are -inf;
        no-op for full DP."""
        return x if geom is None else torch.where(geom, x, neg16)

    rows = min(Lq, int(q_len.max()))

    # ---------------- forward fill ----------------
    hm_all = torch.empty((rows, N, Lr), dtype=SD, device=dev)
    h = torch.zeros((N, Lr), dtype=SD, device=dev)
    f = torch.full((N, Lr), NEGD, dtype=SD, device=dev)
    h_diag = torch.zeros((N, Lr), dtype=SD, device=dev)
    for i in range(rows):
        valid = i < q_len                                        # [N]
        geom = in_geom(i)
        sub = row_scores(i, valid)                               # [N, Lr]
        h_diag[:, 1:] = h[:, :-1]                                # H[i-1][j-1]
        hm = h_diag + sub                                        # match-entering
        f_new = torch.maximum(h - open_, f - ext)
        ht = band_clip(torch.clamp_min(torch.maximum(hm, f_new), 0), geom)
        e = _prefix_max_exclusive(ht + jcost, sc.max_hgap, NEGD) - jcost - (
            open_ - ext)
        h_new = band_clip(torch.maximum(ht, e), geom)
        f_new = band_clip(f_new, geom)
        vr = valid[:, None]
        h = torch.where(vr, h_new, h)
        f = torch.where(vr, f_new, f)
        hm_all[i] = hm
    # hm_all: [rows, N, Lr] int16: best score ending with (i ~ j) matched
    opt = torch.clamp_min(hm_all.amax(dim=(0, 2)).to(I32), 0)   # [N] int32

    # ---------------- backward fill + streaming posterior ----------------
    opt16 = opt.to(SD)
    pos_opt = (opt > 0)[:, None]
    bh = torch.zeros((N, Lr), dtype=SD, device=dev)
    bf = torch.full((N, Lr), NEGD, dtype=SD, device=dev)
    matched = torch.zeros((N, Lr), dtype=torch.bool, device=dev)
    i_first = torch.full((N, Lr), Lq, dtype=I32, device=dev)
    i_last = torch.full((N, Lr), -1, dtype=I32, device=dev)
    bh_diag = torch.zeros((N, Lr), dtype=SD, device=dev)
    for i in range(rows - 1, -1, -1):
        valid = i < q_len
        geom = in_geom(i)
        sub = row_scores(i, valid)
        bh_diag[:, :-1] = bh[:, 1:]                              # bh[i+1][j+1]
        bm = sub + bh_diag
        bf_new = torch.maximum(bh - open_, bf - ext)
        bt = band_clip(torch.clamp_min(torch.maximum(bm, bf_new), 0), geom)
        be = (
            _prefix_max_exclusive((bt - jcost).flip(-1), sc.max_hgap, NEGD).flip(-1)
            + jcost - (open_ - ext)
        )
        bh_new = band_clip(torch.maximum(bt, be), geom)
        bf_new = band_clip(bf_new, geom)
        vr = valid[:, None]
        hm_row = hm_all[i]
        on_path = (
            ((hm_row + bh_diag) == opt16[:, None])
            & (hm_row > NEGD // 2)
            & pos_opt
        )
        bh = torch.where(vr, bh_new, bh)
        bf = torch.where(vr, bf_new, bf)
        # descending i: overwriting i_first converges to the minimum;
        # i_last keeps the first (= largest) row seen.
        i_first = torch.where(on_path, i, i_first)
        i_last = torch.where(on_path & ~matched, i, i_last)
        matched = matched | on_path
    base, ins_pack = derive_base_ins(q, q_len, matched, i_last)
    return PosteriorSummary(
        opt=opt, matched=matched, i_first=i_first, i_last=i_last,
        base=base, ins_pack=ins_pack,
    )


def derive_base_ins(q, q_len, matched, i_last):
    """Gather-based base / packed-insertion derivation (the kernels
    capture these during their backward sweep).  Offsets past q_len
    pack as 0, unmatched columns are 0."""
    N, Lq = q.shape
    Lr = matched.shape[1]
    dev = q.device
    q64 = q.to(torch.int64)
    safe_il = torch.where(matched, i_last, 0).clamp(0, Lq - 1).to(torch.int64)
    base = torch.where(matched, torch.gather(q64, 1, safe_il), 0).to(I32)
    k = torch.arange(INS_PACK, device=dev)[None, None, :]
    gidx = safe_il[:, :, None] + 1 + k                       # [N, Lr, K]
    ins = torch.gather(
        q64, 1, gidx.clamp(0, Lq - 1).reshape(N, Lr * INS_PACK)
    ).reshape(N, Lr, INS_PACK)
    ins = torch.where(gidx < q_len.to(torch.int64)[:, None, None], ins, 0)
    # int32 wrap-around of the JAX sum: exact int64 sum, low 32 bits
    packed = (ins << (2 * k)).sum(dim=2)
    ins_pack = torch.where(matched, _wrap32(packed), 0).to(I32)
    return base, ins_pack


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(I32)


class SpanResult(NamedTuple):
    """Begin/end coordinates of one optimal local alignment per lane —
    the data the reference reads off SSW's Alignment struct."""

    opt: torch.Tensor        # [N]
    q_begin: torch.Tensor    # [N] first matched query index (or 0)
    q_end: torch.Tensor      # [N] last matched query index (or -1)
    r_begin: torch.Tensor    # [N]
    r_end: torch.Tensor      # [N]
    valid: torch.Tensor      # [N] bool: any match


def summary_spans(s: PosteriorSummary) -> SpanResult:
    """Bounding box of matched cells (ties: union box — the reference's
    SSW picks one arbitrary optimum; tie behavior is unspecified there)."""
    N, Lr = s.matched.shape
    dev = s.matched.device
    any_match = s.matched.any(dim=1)
    rj = torch.arange(Lr, dtype=I32, device=dev)[None, :]
    big = Lr + 10
    m = s.matched
    r_begin = torch.where(m, rj, big).amin(dim=1)
    r_end = torch.where(m, rj, -1).amax(dim=1)
    q_begin = torch.where(m, s.i_first, big + Lr).amin(dim=1)
    q_end = torch.where(m, s.i_last, -1).amax(dim=1)
    return SpanResult(
        opt=s.opt,
        q_begin=torch.where(any_match, q_begin, 0).to(I32),
        q_end=torch.where(any_match, q_end, -1).to(I32),
        r_begin=torch.where(any_match, r_begin, 0).to(I32),
        r_end=torch.where(any_match, r_end, -1).to(I32),
        valid=any_match,
    )
