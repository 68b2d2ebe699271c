"""Realign-vote window consensus (device side, PyTorch).

Every fragment of a window is locally aligned to the window template in
one fixed-shape batch (ops/cuda_align.py), and the consensus is read
off per-column vote tallies of the match posterior:

  * substitution votes: fragments matched at template column j vote
    their aligned base,
  * deletion votes: fragments whose alignment span covers j without
    matching it vote to delete the column,
  * insertion votes: fragment bases falling between matches to
    consecutive matched columns vote, offset by offset, to extend an
    insertion after the left column (majority-of-covering rule).

Columns with fewer than `min_column_support` covering fragments keep
the template base.

All tensors are fixed-shape [B windows, S fragment slots, ...]; ragged
piles are padded with zero-length fragments that vote for nothing.
Byte layouts and results are bit-equal to consent_tpu.ops.consensus.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from consent_tpu_torch.ops import align as align_ops
from consent_tpu_torch.ops import cuda_align

INS_CAP = 16  # max insertion bases tracked per column boundary

# Warm refinement rounds never realign fewer than this many fragment
# slots, whatever warm_frac says: below 5 voters the CLR indel noise
# leaks into the intermediate template faster than the fraction saves
# kernel time.
WARM_MIN_SLOTS = 5

I32 = torch.int32


class WindowVotes(NamedTuple):
    """Per-window consensus description, all device tensors."""

    col_base: torch.Tensor   # [B, W] int8: consensus base per template column
    col_del: torch.Tensor    # [B, W] bool: column deleted
    ins_len: torch.Tensor    # [B, W] int32: insertion length after column j
    ins_base: torch.Tensor   # [B, W, INS_CAP] int8: insertion bases
    coverage: torch.Tensor   # [B, W] int32: fragments covering each column
    n_matched: torch.Tensor  # [B, W] int32: fragments matched at each column
    pre_len: torch.Tensor    # [B] int32: insertion length before column 0
    pre_base: torch.Tensor   # [B, INS_CAP] int8 (offset 0 = adjacent to col 0)
    suf_len: torch.Tensor    # [B] int32: insertion length after the last column
    suf_base: torch.Tensor   # [B, INS_CAP] int8 (offset 0 = adjacent to last col)


def _last_not(x: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Per row: at each j, x at the last column <= j whose value is not
    `sentinel` (sentinel if none) — the associative scan
    `b if b != sentinel else a` of the JAX package."""
    W = x.shape[-1]
    pos = torch.arange(W, device=x.device).expand_as(x)
    src = torch.where(x != sentinel, pos, -1).cummax(dim=-1).values
    got = torch.gather(x, -1, src.clamp_min(0))
    return torch.where(src >= 0, got, sentinel)


def _propagate_forward(vals: torch.Tensor, is_start: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """Per row: broadcast vals at segment-start columns rightward
    across each segment.  vals must never equal `sentinel`."""
    return _last_not(torch.where(is_start, vals, sentinel), sentinel)


def _propagate_backward(vals: torch.Tensor, is_end: torch.Tensor,
                        sentinel: int) -> torch.Tensor:
    """Per row: broadcast vals at segment-end columns leftward."""
    return _propagate_forward(
        vals.flip(-1), is_end.flip(-1), sentinel
    ).flip(-1)


def _nearest_valid_right(vals: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Per row, at each j: vals at the nearest valid column strictly to
    the right (-1 if none).  vals/valid: [..., W]."""
    at_or_after = _last_not(
        torch.where(valid, vals, -1).flip(-1), -1
    ).flip(-1)
    after = torch.full_like(at_or_after, -1)
    after[..., :-1] = at_or_after[..., 1:]
    return after


def _red16(x: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """Sum over fragment slots: [B*S, ...] -> [B, ...] int32.  Counts
    fit int16 (bounded by the slot cap max_msa + 1 < 30000), so the
    accumulator is int16 as in the JAX package."""
    return x.to(torch.int16).reshape(B, S, *x.shape[1:]).sum(
        dim=1, dtype=torch.int16
    ).to(I32)


def _argmax_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """argmax with ties broken toward the lowest index (jnp.argmax)."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    best = x.amax(dim=dim, keepdim=True)
    return torch.where(x == best, idx, n).amin(dim=dim)


def consensus_votes(
    frags: torch.Tensor,      # [B, S, Lf] uint8 codes
    frag_len: torch.Tensor,   # [B, S] int32 (0 = empty slot)
    tpl: torch.Tensor,        # [B, W] uint8
    tpl_len: torch.Tensor,    # [B] int32 (== W normally)
    *,
    S: int,
    min_column_support: int = 2,
    scoring: align_ops.Scoring = align_ops.Scoring(),
    frag_d0: torch.Tensor | None = None,  # [B, S] expected start column
) -> WindowVotes:
    """Batched realign-vote consensus."""
    B, S_, Lf = frags.shape
    assert S_ == S
    W = tpl.shape[1]
    dev = frags.device

    q = frags.reshape(B * S, Lf).contiguous()
    q_len = frag_len.reshape(B * S).to(I32).contiguous()
    r = tpl.repeat_interleave(S, dim=0).contiguous()
    r_len = tpl_len.to(I32).repeat_interleave(S).contiguous()
    d0 = None if frag_d0 is None else frag_d0.reshape(B * S).to(I32).contiguous()

    summ = cuda_align.posterior_summary(q, q_len, r, r_len, scoring, d0=d0)
    N = B * S
    matched = summ.matched                               # [N, W]
    big = Lf + W + 10
    i_first = torch.where(matched, summ.i_first, big)
    i_last = torch.where(matched, summ.i_last, -1)

    # aligned base per column (captured by the aligner, no gather)
    base = summ.base                                     # [N, W]

    def red(x):
        return _red16(x, B, S)

    # coverage span of each fragment on the template
    rj = torch.arange(W, dtype=I32, device=dev)[None, :]
    r_begin = torch.where(matched, rj, big).amin(dim=1, keepdim=True)
    r_end = torch.where(matched, rj, -1).amax(dim=1, keepdim=True)
    cover = (rj >= r_begin) & (rj <= r_end)              # [N, W]

    # insertions between consecutive matched columns
    nxt_first = _nearest_valid_right(i_first, matched)   # [N, W]
    has_bnd = matched & (nxt_first >= 0)
    ins_count = torch.where(has_bnd, nxt_first - i_last - 1, 0)
    ins_count = ins_count.clamp(0, INS_CAP)

    # unpack up to INS_CAP inserted bases per boundary from the
    # aligner's 2-bit-packed capture (no gather)
    assert INS_CAP == align_ops.INS_PACK
    k = torch.arange(INS_CAP, dtype=I32, device=dev)[None, None, :]
    ins_codes = (summ.ins_pack[:, :, None] >> (2 * k)) & 3   # [N, W, K]
    ins_valid = k < ins_count[:, :, None]                # [N, W, K]

    # ---- reduce over fragment slots per window ----
    four = torch.arange(4, dtype=I32, device=dev)
    onehot = (base[:, :, None] == four) & matched[:, :, None]
    votes_base = red(onehot)           # [B, W, 4]
    votes_del = red(cover & ~matched)  # [B, W]
    coverage = red(cover)              # [B, W]
    n_matched = red(matched)           # [B, W]

    cand = torch.cat([votes_base, votes_del[:, :, None]], dim=2)
    winner = _argmax_first(cand, 2)                      # [B, W]; 4 == delete
    keep_tpl = coverage < min_column_support
    col_base = torch.where(
        keep_tpl | (winner == 4), tpl.to(torch.int64), winner
    ).to(torch.int8)
    col_del = (winner == 4) & ~keep_tpl

    # ---- insertion majority per boundary ----
    votes_bnd = red(has_bnd)           # [B, W]
    more = red(ins_count[:, :, None] > k)  # [B, W, K]
    stop = votes_bnd[:, :, None] - more
    extend = more > stop                                 # strict majority
    ins_len = torch.cumprod(extend.to(I32), dim=2).sum(dim=2, dtype=I32)

    ins_onehot = (ins_codes[:, :, :, None] == four) & ins_valid[:, :, :, None]
    ins_votes = red(ins_onehot)        # [B, W, K, 4]
    ins_base = _argmax_first(ins_votes, 3).to(torch.int8)

    # ---- equal-base-run conservation votes ----
    # Inside a run of equal template bases every column is matched on
    # SOME optimal path, so the union-of-paths posterior never exposes
    # an indel there.  Base-count conservation does: an anchored
    # fragment consumes i_last[run_end] - i_first[run_begin] + 1 query
    # bases across the run; deficit vs the run length votes deletions
    # of run columns, surplus votes insertions of the run base,
    # majority-aggregated per unit like the boundary insertions.
    tpl32 = tpl.to(I32)
    colw = rj.expand(B, W)
    valid_col = colw < tpl_len.to(I32)[:, None]
    prev_tpl = torch.full_like(tpl32, -1)
    prev_tpl[:, 1:] = tpl32[:, :-1]
    is_start_w = (
        (colw == 0) | (tpl32 != prev_tpl) | ~valid_col
        | (colw == tpl_len.to(I32)[:, None])
    )
    is_end_w = torch.ones_like(is_start_w)
    is_end_w[:, :-1] = is_start_w[:, 1:]
    SENT = -(1 << 20)
    rbeg = _propagate_forward(colw, is_start_w, SENT)
    rend = _propagate_backward(colw, is_end_w, SENT)
    run_len = rend - rbeg + 1

    def rep(x):
        return x.repeat_interleave(S, dim=0)

    # one forward scan carries both run-start values each fragment
    # needs — i_first[rbeg] and matched[rbeg], packed into one int32;
    # at a run-END column j, i_last[rend] == i_last[j] and matched[rend]
    # == matched[j]
    is_start = rep(is_start_w)
    pk = _propagate_forward(i_first * 2 + matched.to(I32), is_start, SENT)
    fb = pk >> 1                                         # i_first[rbeg]
    m_beg = (pk & 1) == 1                                # matched[rbeg]
    at_end = rep(is_end_w & valid_col)
    anch_end = m_beg & matched & at_end
    consumed = i_last - fb + 1
    deficit = torch.where(anch_end, rep(run_len) - consumed, 0)

    n_anch = red(anch_end)                               # [B, W]
    del_more = red((deficit[:, :, None] > k) & anch_end[:, :, None])
    del_run = torch.cumprod(
        (del_more > n_anch[:, :, None] - del_more).to(I32), dim=2
    ).sum(dim=2, dtype=I32)
    ins_more = red((-deficit[:, :, None] > k) & anch_end[:, :, None])
    ins_run = torch.cumprod(
        (ins_more > n_anch[:, :, None] - ins_more).to(I32), dim=2
    ).sum(dim=2, dtype=I32)
    gate = (n_anch < min_column_support) | keep_tpl
    del_run = torch.where(gate, 0, torch.minimum(del_run, run_len - 1))
    ins_run = torch.where(gate, 0, ins_run)

    # apply: delete the last del_run columns of each run ...
    del_back = _propagate_backward(del_run, is_end_w, SENT)
    col_del = col_del | ((rend - colw) < del_back)
    # ... and splice ins_run copies of the run base before the existing
    # insertion at the run's end column: result[k] = run base for
    # k < ins_run, else ins_base[k - ins_run]
    irun = ins_run[:, :, None].to(torch.int64)
    kk = torch.arange(INS_CAP, device=dev)[None, None, :]
    src = (kk - irun).clamp_min(0)
    shifted = torch.where(
        kk >= irun, torch.gather(ins_base.to(I32), 2, src), 0
    )
    ins_base = torch.where(kk < irun, tpl32[:, :, None], shifted).to(
        torch.int8)
    ins_len = (ins_len + ins_run).clamp(0, INS_CAP)

    # ---- window-edge insertions ----
    # Fragments matched at template column 0 vote their unmatched
    # leading bases as an insertion before the window; symmetric for
    # the last real column.  Offsets count outward from the window edge.
    kk1 = torch.arange(INS_CAP, dtype=I32, device=dev)[None, :]   # [1, K]
    q64 = q.to(torch.int64)

    pre_valid = matched[:, 0]                            # [N]
    pre_cnt = torch.where(pre_valid, i_first[:, 0].clamp(0, INS_CAP), 0)
    pre_idx = (i_first[:, 0:1] - 1 - kk1).clamp(0, Lf - 1)        # [N, K]
    pre_codes = torch.gather(q64, 1, pre_idx.to(torch.int64))
    pre_ok = kk1 < pre_cnt[:, None]
    pre_len, pre_base = _edge_majority(
        pre_valid, pre_cnt, pre_codes, pre_ok, B, S
    )

    last_col = (r_len - 1).clamp(0, W - 1).to(torch.int64)        # [N]
    m_last = torch.gather(matched, 1, last_col[:, None])[:, 0]
    il_last = torch.gather(i_last, 1, last_col[:, None])[:, 0]
    suf_cnt = torch.where(
        m_last, (q_len - 1 - il_last).clamp(0, INS_CAP), 0
    )
    suf_idx = (il_last[:, None] + 1 + kk1).clamp(0, Lf - 1)
    suf_codes = torch.gather(q64, 1, suf_idx.to(torch.int64))
    suf_ok = kk1 < suf_cnt[:, None]
    suf_len, suf_base = _edge_majority(
        m_last, suf_cnt, suf_codes, suf_ok, B, S
    )

    return WindowVotes(
        col_base=col_base,
        col_del=col_del,
        ins_len=ins_len.to(I32),
        ins_base=ins_base,
        coverage=coverage,
        n_matched=n_matched,
        pre_len=pre_len,
        pre_base=pre_base,
        suf_len=suf_len,
        suf_base=suf_base,
    )


def _edge_majority(valid, cnt, codes, ok, B, S):
    """Majority insertion vote at a window edge.

    valid/cnt: [N]; codes/ok: [N, K].  Returns ([B] int32, [B, K] int8)."""
    K = codes.shape[1]
    dev = codes.device
    kk = torch.arange(K, device=dev)[None, :]

    def red(x):
        return x.reshape(B, S, *x.shape[1:]).sum(dim=1, dtype=I32)

    n_valid = red(valid.to(I32))                                 # [B]
    more = red((cnt[:, None] > kk).to(I32))                      # [B, K]
    stop = n_valid[:, None] - more
    extend = more > stop
    length = torch.cumprod(extend.to(I32), dim=1).sum(dim=1, dtype=I32)
    four = torch.arange(4, device=dev)
    onehot = (codes[:, :, None] == four) & ok[:, :, None]
    votes = red(onehot.to(I32))                                  # [B, K, 4]
    base = _argmax_first(votes, 2).to(torch.int8)
    return length, base


def _pack2(b: torch.Tensor) -> torch.Tensor:
    """[..., K] base codes -> [...] int32, 2 bits each, LSB first."""
    kk = torch.arange(b.shape[-1], device=b.device)
    packed = ((b.to(torch.int64) & 3) << (2 * kk)).sum(dim=-1)
    return align_ops._wrap32(packed)


def assemble_template_device(
    v: WindowVotes,
    tpl_len: torch.Tensor,  # [B] int32: this round's template lengths
    Lt: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side consensus assembly for the NEXT refinement round.

    Bit-equal to the host chain `assemble_consensus_batch(votes,
    tpl_len)` followed by truncation to Lt and zero-padding — the
    layout (prefix insertion reversed, then per kept column its base
    followed by the insertion after it, then the suffix insertion) is a
    prefix-sum placement: output position t belongs to the column whose
    segment [start_j, e_j) holds it, found by a sorted search over the
    inclusive segment ends e.

    Returns (new_tpl [B, Lt] uint8, new_len [B] int32).
    """
    col_base = v.col_base.to(torch.int64)
    B, W = col_base.shape
    dev = col_base.device
    ins_pack = _pack2(v.ins_base).to(torch.int64)        # [B, W]
    pre_pack = _pack2(v.pre_base).to(torch.int64)        # [B]
    suf_pack = _pack2(v.suf_base).to(torch.int64)        # [B]
    pre = v.pre_len.to(torch.int64)
    suf = v.suf_len.to(torch.int64)

    colj = torch.arange(W, device=dev)[None, :]
    valid = colj < tpl_len.to(torch.int64)[:, None]
    keep = (valid & ~v.col_del).to(torch.int64)
    il = torch.where(valid, v.ins_len.to(torch.int64), 0)
    cnt = keep + il                                      # bases from col j
    # absolute (prefix-included) exclusive segment ends per column
    e = pre[:, None] + torch.cumsum(cnt, dim=1)          # [B, W]
    start = e - cnt
    main_end = e[:, -1:]                                 # [B, 1]
    total = main_end[:, 0] + suf

    tt = torch.arange(Lt, device=dev)[None, :].expand(B, Lt).contiguous()
    # column of position t: #{j : e_j <= t}
    jt = torch.searchsorted(e.contiguous(), tt, right=True)
    jc = jt.clamp_max(W - 1)
    startj = torch.gather(start, 1, jc)
    keepj = torch.gather(keep, 1, jc)
    cbj = torch.gather(col_base, 1, jc) & 3
    ipj = torch.gather(ins_pack, 1, jc)

    in_pre = tt < pre[:, None]
    in_main = ~in_pre & (tt < main_end)
    in_suf = (tt >= main_end) & (tt < main_end + suf[:, None])
    off = tt - startj
    ins_idx = (off - keepj).clamp(0, INS_CAP - 1)
    main_base = torch.where(
        (off == 0) & (keepj == 1), cbj, (ipj >> (2 * ins_idx)) & 3
    )
    # prefix offsets count outward from column 0 -> reversed on output
    pre_sh = (pre[:, None] - 1 - tt).clamp(0, INS_CAP - 1)
    pre_b = (pre_pack[:, None] >> (2 * pre_sh)) & 3
    suf_sh = (tt - main_end).clamp(0, INS_CAP - 1)
    suf_b = (suf_pack[:, None] >> (2 * suf_sh)) & 3
    out = torch.where(
        in_pre, pre_b,
        torch.where(in_main, main_base, torch.where(in_suf, suf_b, 0)),
    )
    new_len = total.clamp_max(Lt).to(I32)
    return out.to(torch.uint8), new_len


def consensus_votes_rounds(
    frags, frag_len, tpl, tpl_len, *, S, rounds, min_column_support,
    scoring, frag_d0=None, warm_frac: float = 1.0,
):
    """`rounds` refinement rounds: each round's consensus is assembled
    on the device (assemble_template_device) and becomes the next
    round's template.  Returns (final WindowVotes, final template
    lengths [B]).

    warm_frac < 1 runs the WARM rounds (all but the last) on only the
    top max(WARM_MIN_SLOTS, ceil(S * warm_frac)) fragment slots — the
    engine fills slots best-match-first, and a warm round's sole
    product is the next template."""
    Lt = tpl.shape[1]
    for _ in range(max(1, rounds) - 1):
        if warm_frac < 1.0:
            Sw = min(S, max(WARM_MIN_SLOTS, math.ceil(S * warm_frac)))
            v = consensus_votes(
                frags[:, :Sw], frag_len[:, :Sw], tpl, tpl_len, S=Sw,
                min_column_support=min_column_support, scoring=scoring,
                frag_d0=None if frag_d0 is None else frag_d0[:, :Sw],
            )
        else:
            v = consensus_votes(
                frags, frag_len, tpl, tpl_len, S=S,
                min_column_support=min_column_support, scoring=scoring,
                frag_d0=frag_d0,
            )
        tpl, tpl_len = assemble_template_device(v, tpl_len, Lt)
    v = consensus_votes(
        frags, frag_len, tpl, tpl_len, S=S,
        min_column_support=min_column_support, scoring=scoring,
        frag_d0=frag_d0,
    )
    return v, tpl_len


def pack_bases_host(codes: np.ndarray) -> np.ndarray:
    """Host: 2-bit pack base codes along the last axis (4 bases/byte,
    LSB first).  Length must be a multiple of 4 (engine lengths are
    multiples of 128).  Quarters the host->device fragment upload."""
    x = codes.reshape(*codes.shape[:-1], -1, 4).astype(np.uint8)
    return (
        x[..., 0] | (x[..., 1] << 2) | (x[..., 2] << 4) | (x[..., 3] << 6)
    )


def unpack_bases(packed: torch.Tensor, L: int) -> torch.Tensor:
    """Device inverse of pack_bases_host: [..., L//4] -> [..., L]."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    x = (packed[..., None] >> shifts) & 3
    return x.reshape(*packed.shape[:-1], L)


def wire_encode_inputs(frags_packed, frag_len, tpl, tpl_len, frag_d0):
    """Host: [B, S*P | 4S | Lt | 4 | 4S] uint8 rows (little-endian
    int32 fields via numpy views)."""
    B, S, Pb = frags_packed.shape
    def b4(x):
        return np.ascontiguousarray(x.astype(np.int32)).view(np.uint8)

    return np.concatenate(
        [
            frags_packed.reshape(B, S * Pb),
            b4(frag_len).reshape(B, 4 * S),
            np.ascontiguousarray(tpl, dtype=np.uint8),
            b4(tpl_len[:, None]).reshape(B, 4),
            b4(frag_d0).reshape(B, 4 * S),
        ],
        axis=1,
    )


def _bitcast32(u8: torch.Tensor) -> torch.Tensor:
    """uint8[..., 4k] -> int32[..., k] (little-endian)."""
    return u8.contiguous().view(I32)


def _bytes32(x: torch.Tensor) -> torch.Tensor:
    """int32[B, ...] -> uint8[B, 4 * ...] (little-endian)."""
    return x.to(I32).contiguous().view(torch.uint8).reshape(x.shape[0], -1)


def pack_bases_device(codes: torch.Tensor) -> torch.Tensor:
    """Device inverse of unpack_bases: [..., L] codes -> [..., L//4]
    bytes (LSB first), matching pack_bases_host."""
    x = codes.reshape(*codes.shape[:-1], -1, 4).to(torch.uint8)
    return (
        x[..., 0]
        | (x[..., 1] << 2)
        | (x[..., 2] << 4)
        | (x[..., 3] << 6)
    )


def consensus_votes_wire(
    buf: torch.Tensor,  # [B, S*Pb + 4S + Lt + 4 + 4S] uint8
    *,
    S: int,
    Pb: int,           # packed fragment bytes (Lf // 4)
    Lt: int,
    min_column_support: int = 2,
    scoring: align_ops.Scoring = align_ops.Scoring(),
    rounds: int = 1,
    assemble_out: bool = False,
    warm_frac: float = 1.0,
) -> torch.Tensor:      # [B, 7*Lt + 20] u8, or [B, Lt//4 + 4] assembled
    """All `rounds` refinement rounds in ONE call on the device — each
    window round-trips its votes exactly once regardless of
    consensus_rounds.

    assemble_out=True (the production path) also assembles the final
    consensus on the device and returns only its 2-bit-packed codes +
    length — [B, Lt//4 + 4] bytes instead of [B, 7*Lt + 20]."""
    B = buf.shape[0]
    o = 0
    frags = unpack_bases(buf[:, : S * Pb].reshape(B, S, Pb), Pb * 4)
    o += S * Pb
    frag_len = _bitcast32(buf[:, o : o + 4 * S])
    o += 4 * S
    tpl = buf[:, o : o + Lt]
    o += Lt
    tpl_len = _bitcast32(buf[:, o : o + 4])[:, 0]
    o += 4
    frag_d0 = _bitcast32(buf[:, o : o + 4 * S])

    votes, w_len = consensus_votes_rounds(
        frags, frag_len, tpl, tpl_len, S=S, rounds=rounds,
        min_column_support=min_column_support, scoring=scoring,
        frag_d0=frag_d0 if scoring.band else None, warm_frac=warm_frac,
    )

    if assemble_out:
        cons, cons_len = assemble_template_device(votes, w_len, Lt)
        return torch.cat(
            [pack_bases_device(cons), _bytes32(cons_len[:, None])], dim=1
        )

    return torch.cat(
        [
            votes.col_base.view(torch.uint8),
            votes.col_del.to(torch.uint8),
            votes.ins_len.to(torch.uint8),
            _bytes32(_pack2(votes.ins_base)),
            _bytes32(votes.pre_len[:, None]),
            _bytes32(_pack2(votes.pre_base)[:, None]),
            _bytes32(votes.suf_len[:, None]),
            _bytes32(_pack2(votes.suf_base)[:, None]),
            _bytes32(w_len[:, None]),
        ],
        dim=1,
    )


def wire_decode_cons(arr: np.ndarray, Lt: int) -> list:
    """Host inverse of the assemble_out wire layout: list of per-window
    consensus code arrays (uint8, true lengths)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    Pb = Lt // 4
    packed = arr[:, :Pb]
    lens = arr[:, Pb : Pb + 4].copy().view(np.int32)[:, 0]
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(len(arr), Lt)
    return [codes[b, : lens[b]] for b in range(len(arr))]
