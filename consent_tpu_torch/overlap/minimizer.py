"""Native minimizer-based all-vs-all overlapper (vectorized NumPy).

The reference shells out to minimap2 for both self-overlaps and
read-to-contig mapping (CONSENT-correct:185-187, CONSENT-polish:189).
This module provides a built-in replacement with the same output
contract (PAF-shaped records, inclusive-end Overlap rows) for
environments without minimap2 and as the default overlap source.

Algorithm (minimap-style, simplified):
  1. canonical (w, k)-minimizers per sequence with an invertible
     64-bit mixer,
  2. hash join of minimizer tables (over-frequent seeds dropped),
  3. per (query, target, relative-strand) diagonal clustering,
  4. cluster -> overlap span + minimizer-count score.

Defaults approximate minimap2's PacBio preset (-k15 -w5 ~ the
reference's PB invocation uses minimap2 defaults k=15 w=10 with -w5
override; CONSENT-correct:185).

Every stage is fully vectorized: the hash join runs a bucketed
vectorized binary search over a radix-bucket table built at index
time (replacing one wide searchsorted per query), hit expansion is a
repeat/cumsum identity (no per-hit arange), and cluster spans reduce
with minimum/maximum.reduceat (no per-cluster Python loop) — this
stage is half the end-to-end wall on small hosts (VERDICT r4 #4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from consent_tpu_torch.io import seqs
from consent_tpu_torch.io.paf import OVERLAP_DTYPE, Pile


@dataclasses.dataclass(frozen=True)
class OverlapParams:
    k: int = 15
    w: int = 5
    max_occ: int = 200          # drop minimizers occurring more often
    min_span: int = 100         # minimum overlap span (bases)
    min_count: int = 4          # minimum shared minimizers per overlap
    diag_tolerance: int = 500   # diagonal clustering width
    chain_gap: int = 1000       # split chains at larger position jumps


def _mix64(x: np.ndarray) -> np.ndarray:
    """Invertible 64-bit mixer (splitmix64 finalizer) — decorrelates
    lexicographic k-mer order so window minima are pseudo-random."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _kmers_u64(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    # rolling via cumulative shifts: kmer[i] = sum codes[i+j] << 2(k-1-j)
    for j in range(k):
        out = (out << np.uint64(2)) | codes[j : j + n].astype(np.uint64)
    return out


def _rc_kmers_u64(fwd: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement k-mers straight from the forward k-mers by
    2-bit field reversal + complement — bit-equal to
    `_kmers_u64(seqs.revcomp(codes), k)[::-1]` (complement code is
    3 - c = c ^ 3) at ~k/6 of its cost."""
    ones = np.uint64(((1 << (2 * k)) - 1) & 0xFFFFFFFFFFFFFFFF)
    y = (fwd ^ ones).astype(np.uint64)
    m2 = np.uint64(0x3333333333333333)
    y = ((y >> np.uint64(2)) & m2) | ((y & m2) << np.uint64(2))
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    y = ((y >> np.uint64(4)) & m4) | ((y & m4) << np.uint64(4))
    y = y.byteswap()
    return y >> np.uint64(64 - 2 * k)


def minimizers(codes: np.ndarray, params: OverlapParams
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hash, pos, strand) canonical minimizers of one sequence.

    strand False = forward k-mer is canonical."""
    k, w = params.k, params.w
    n = len(codes) - k + 1
    if n < w:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.bool_))
    fwd = _kmers_u64(codes, k)
    rc = _rc_kmers_u64(fwd, k)
    strand = rc < fwd
    canon = np.where(strand, rc, fwd)
    h = _mix64(canon)
    # sliding window minimum over w positions
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    arg = win.argmin(axis=1)
    pos = np.arange(len(arg)) + arg
    # dedupe consecutive duplicates
    keep = np.empty(len(pos), dtype=bool)
    keep[0] = True
    keep[1:] = pos[1:] != pos[:-1]
    pos = pos[keep]
    return h[pos], pos.astype(np.int64), strand[pos]


def _minimizers_block(codes_list: Sequence[np.ndarray],
                      params: OverlapParams) -> List[tuple]:
    """minimizers() for a block of sequences at once: one [R, Lmax]
    padded matrix, every pass vectorized across rows — per-read numpy
    op overhead (the GIL-bound cost of per-read extraction) amortizes
    over the block.  Bit-equal to per-read minimizers()."""
    k, w = params.k, params.w
    R = len(codes_list)
    lens = np.fromiter((len(c) for c in codes_list), np.int64, R)
    ni = lens - k + 1                       # valid k-mer count per row
    Lmax = int(lens.max()) if R else 0
    n = Lmax - k + 1
    empty = (np.empty(0, np.uint64), np.empty(0, np.int64),
             np.empty(0, np.bool_))
    if n < w:
        return [empty] * R
    mat = np.zeros((R, Lmax), np.uint8)
    for i, c in enumerate(codes_list):
        mat[i, : len(c)] = c
    fwd = np.zeros((R, n), np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | mat[:, j : j + n]
    rc = _rc_kmers_u64(fwd, k)
    strand = rc < fwd
    h = _mix64(np.where(strand, rc, fwd))
    col = np.arange(n)
    # out-of-row positions get the max hash so they never win a
    # window minimum; windows reaching past a row's end are dropped
    hmask = np.where(col[None, :] < ni[:, None], h,
                     np.uint64(0xFFFFFFFFFFFFFFFF))
    win = np.lib.stride_tricks.sliding_window_view(hmask, w, axis=1)
    arg = win.argmin(axis=2)                # [R, n-w+1]
    pos = np.arange(n - w + 1)[None, :] + arg
    keep = np.empty(pos.shape, dtype=bool)
    keep[:, 0] = True
    keep[:, 1:] = pos[:, 1:] != pos[:, :-1]
    keep &= np.arange(n - w + 1)[None, :] < (ni - w + 1)[:, None]
    out = []
    for i in range(R):
        if ni[i] < w:
            out.append(empty)
            continue
        p = pos[i][keep[i]]
        out.append((h[i][p], p.astype(np.int64), strand[i][p]))
    return out


class MinimizerIndex:
    """Minimizer table over a set of target sequences.

    `add` only records the sequence; minimizer extraction is deferred
    to `build`, where length-bucketed blocks of reads extract in one
    vectorized pass each, fanned over a thread pool (the numpy rolls
    release the GIL)."""

    def __init__(self, params: OverlapParams = OverlapParams()):
        self.params = params
        self._names: List[str] = []
        self._lens: List[int] = []
        self._pending: List[np.ndarray] = []
        self._h: List[np.ndarray] = []
        self._pos: List[np.ndarray] = []
        self._str: List[np.ndarray] = []

    def add(self, name: str, codes: np.ndarray) -> None:
        self._names.append(name)
        self._lens.append(len(codes))
        self._pending.append(codes)

    def _extract_pending(self) -> None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        items = self._pending
        self._pending = []
        if not items:
            return
        # consecutive blocks bounded by padded area and pad waste
        blocks: List[List[np.ndarray]] = []
        cur: List[np.ndarray] = []
        cur_max = 0
        for c in items:
            L = len(c)
            new_max = max(cur_max, L)
            if cur and (
                len(cur) >= 512
                or new_max * (len(cur) + 1) > 16_000_000
                or (L and new_max > 4 * max(1, min(cur_max, L)))
            ):
                blocks.append(cur)
                cur, cur_max = [], 0
                new_max = L
            cur.append(c)
            cur_max = new_max
        blocks.append(cur)
        nw = os.cpu_count() or 1
        if nw > 1 and len(blocks) > 1:
            with ThreadPoolExecutor(max_workers=nw) as pool:
                outs = pool.map(
                    lambda b: _minimizers_block(b, self.params), blocks
                )
                results = [t for out in outs for t in out]
        else:
            results = [
                t for b in blocks
                for t in _minimizers_block(b, self.params)
            ]
        for h, pos, st in results:
            self._h.append(h)
            self._pos.append(pos)
            self._str.append(st)

    def build(self) -> None:
        self._extract_pending()
        sizes = [len(h) for h in self._h]
        self.t_id = np.repeat(np.arange(len(sizes)), sizes)
        self.h = np.concatenate(self._h) if sizes else np.empty(0, np.uint64)
        self.pos = (np.concatenate(self._pos) if sizes
                    else np.empty(0, np.int64))
        self.strand = (np.concatenate(self._str) if sizes
                       else np.empty(0, np.bool_))
        # order by hash only — everything downstream (grouping,
        # frequency filter, join hits feeding order-invariant cluster
        # reductions behind a stable lexsort) is invariant to the
        # within-hash-group order, so the faster unstable sort is safe
        order = np.argsort(self.h, kind="quicksort")
        h_sorted = self.h[order]
        # frequency filter over the sorted table (group-run scan; the
        # per-group Python loop here used to cost ~11 s at 7M seeds);
        # fused with the sort permutation so payload arrays see ONE
        # gather instead of permute-then-filter
        n = len(h_sorted)
        if n:
            new_grp = np.empty(n, bool)
            new_grp[0] = True
            new_grp[1:] = h_sorted[1:] != h_sorted[:-1]
            grp_starts = np.flatnonzero(new_grp)
            grp_counts = np.empty(len(grp_starts), np.int64)
            grp_counts[:-1] = grp_starts[1:] - grp_starts[:-1]
            grp_counts[-1] = n - grp_starts[-1]
            ok = grp_counts <= self.params.max_occ
            keep = np.repeat(ok, grp_counts)
            sel = order[keep]
            self.h = h_sorted[keep]
            self.t_id = self.t_id[sel]
            self.pos = self.pos[sel]
            self.strand = self.strand[sel]
        else:
            self.h = h_sorted
            self.t_id = self.t_id[order]
            self.pos = self.pos[order]
            self.strand = self.strand[order]
        self._lens_arr = np.asarray(self._lens, dtype=np.int64)
        self._name_id: Dict[str, int] = {
            nm: i for i, nm in enumerate(self._names)
        }
        # radix-bucket table over the hash top bits: the join becomes a
        # per-bucket vectorized binary search (few, short probes)
        # instead of a full-width searchsorted per query
        n = len(self.h)
        if n:
            B = int(np.clip(int(np.ceil(np.log2(n + 1))) + 1, 14, 24))
            self._shift = np.uint64(64 - B)
            # reinterpret, don't convert: shifted values < 2^B < 2^63
            idx = (self.h >> self._shift).view(np.int64)
            counts = np.bincount(idx, minlength=1 << B)
            self._bucket_lo = np.empty((1 << B) + 1, np.int64)
            self._bucket_lo[0] = 0
            np.cumsum(counts, out=self._bucket_lo[1:])
            self._iters = int(counts.max()).bit_length() + 1
        else:
            self._bucket_lo = None

    def join(self, qh: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[lo, hi) row ranges of self.h matching each query hash."""
        h = self.h
        if self._bucket_lo is None or len(qh) == 0:
            z = np.zeros(len(qh), np.int64)
            return z, z
        b = (qh >> self._shift).astype(np.int64)
        lo0 = self._bucket_lo[b]
        hi0 = self._bucket_lo[b + 1]
        nmax = len(h) - 1

        def bound(pred):
            lo, hi = lo0.copy(), hi0.copy()
            for _ in range(self._iters):
                active = lo < hi
                if not active.any():
                    break
                mid = (lo + hi) >> 1
                go = pred(h[np.minimum(mid, nmax)])
                lo = np.where(active & go, mid + 1, lo)
                hi = np.where(active & ~go, mid, hi)
            return lo

        left = bound(lambda v: v < qh)
        right = bound(lambda v: v <= qh)
        return left, right

    def names(self) -> List[str]:
        return self._names

    def length(self, tid: int) -> int:
        return self._lens[tid]


def map_block_arrays(
    index: MinimizerIndex,
    items: Sequence[Tuple[str, np.ndarray]],
    skip_self: bool = True,
):
    """Map a BLOCK of queries against the index in one joined,
    vectorized computation (per-query results are bit-identical to
    mapping each alone; a leading query-ordinal sort key keeps
    clusters per query, in input order).

    Returns a list parallel to `items`: None where nothing maps, else
    a dict of parallel numpy columns (cluster order): tid, q_start,
    q_end (incl.), strand, t_start, t_end (incl.), matches,
    block_len — plus q_len.

    Blocking exists for the GIL: per-query mapping is dozens of tiny
    numpy ops whose interpreter overhead serializes a thread pool
    (measured 2x SLOWER than serial on a 2-core host); block-wide ops
    release the GIL for real."""
    p = index.params
    R = len(items)
    none_out: List = [None] * R
    if len(index.h) == 0 or R == 0:
        return none_out
    mins = _minimizers_block([c for _, c in items], p)
    sizes = np.fromiter((len(h) for h, _, _ in mins), np.int64, R)
    if sizes.sum() == 0:
        return none_out
    qh = np.concatenate([h for h, _, _ in mins])
    qpos = np.concatenate([pp for _, pp, _ in mins])
    qstr = np.concatenate([s for _, _, s in mins])
    qid = np.repeat(np.arange(R), sizes)
    q_lens = np.fromiter((len(c) for _, c in items), np.int64, R)

    lo, hi = index.join(qh)
    n_hits = hi - lo
    tot = int(n_hits.sum())
    if tot == 0:
        return none_out
    q_idx = np.repeat(np.arange(len(qh)), n_hits)
    # per-hit row index without a per-range arange: global position
    # minus each range's exclusive start, plus its table offset
    cum = np.cumsum(n_hits) - n_hits
    t_rows = (
        np.arange(tot, dtype=np.int64)
        - np.repeat(cum, n_hits)
        + np.repeat(lo, n_hits)
    )

    tid = index.t_id[t_rows]
    tpos = index.pos[t_rows]
    tstr = index.strand[t_rows]
    qq = qpos[q_idx]
    hid = qid[q_idx]
    rel_strand = (qstr[q_idx] != tstr)          # True = '-'

    if skip_self:
        sids = np.fromiter(
            (index._name_id.get(nm, -1) for nm, _ in items), np.int64, R
        )
        keep = tid != sids[hid]
        tid, tpos, qq, hid, rel_strand = (
            tid[keep], tpos[keep], qq[keep], hid[keep], rel_strand[keep]
        )
    if len(tid) == 0:
        return none_out

    # diagonal per relative strand: '+': q - t ; '-': q + t
    diag = np.where(rel_strand, qq + tpos, qq - tpos)
    key_strand = rel_strand.astype(np.int64)
    order = np.lexsort((diag, key_strand, tid, hid))
    tid, tpos, qq, hid, rel_strand, diag = (
        tid[order], tpos[order], qq[order], hid[order],
        rel_strand[order], diag[order],
    )

    # cluster breaks: new query/target/strand or diagonal jump
    brk = np.empty(len(tid), dtype=bool)
    brk[0] = True
    brk[1:] = (
        (hid[1:] != hid[:-1])
        | (tid[1:] != tid[:-1])
        | (rel_strand[1:] != rel_strand[:-1])
        | (np.abs(diag[1:] - diag[:-1]) > p.diag_tolerance)
    )
    starts = np.flatnonzero(brk)
    counts = np.empty(len(starts), np.int64)
    counts[:-1] = starts[1:] - starts[:-1]
    counts[-1] = len(tid) - starts[-1]

    ctid = tid[starts]
    crev = rel_strand[starts]
    cqid = hid[starts]
    qs = np.minimum.reduceat(qq, starts)
    qe = np.maximum.reduceat(qq, starts) + p.k - 1
    ts = np.minimum.reduceat(tpos, starts)
    te = np.maximum.reduceat(tpos, starts) + p.k - 1
    t_len = index._lens_arr[ctid]
    q_len = q_lens[cqid]

    # dovetail end-extension: seeds stop at the last shared minimizer;
    # extend the span along the diagonal until one sequence runs out
    # (what aligner-backed overlappers report)
    ext1 = np.minimum(qs, np.where(crev, t_len - 1 - te, ts))
    qs = qs - ext1
    ts = np.where(crev, ts, ts - ext1)
    te = np.where(crev, te + ext1, te)
    ext2 = np.minimum(q_len - 1 - qe, np.where(crev, ts, t_len - 1 - te))
    qe = qe + ext2
    ts = np.where(crev, ts - ext2, ts)
    te = np.where(crev, te, te + ext2)

    keep = (
        (counts >= p.min_count)
        & (qe - qs + 1 >= p.min_span)
        & (te - ts + 1 >= p.min_span)
    )
    if not keep.any():
        return none_out
    ctid, crev, counts, cqid = (
        ctid[keep], crev[keep], counts[keep], cqid[keep]
    )
    qs, qe, ts, te = qs[keep], qe[keep], ts[keep], te[keep]
    t_len, q_len = t_len[keep], q_len[keep]
    matches = (counts * p.k * 0.6).astype(np.int64)
    span = np.maximum(qe - qs + 1, te - ts + 1)
    matches = np.minimum(matches, span)

    # slice per query (cqid is non-decreasing: qid was the primary
    # sort key and masking preserves order)
    bounds = np.searchsorted(cqid, np.arange(R + 1))
    out: List = []
    for i in range(R):
        a, b = bounds[i], bounds[i + 1]
        if a == b:
            out.append(None)
            continue
        sl = slice(a, b)
        out.append({
            "q_len": int(q_lens[i]), "tid": ctid[sl],
            "q_start": qs[sl], "q_end": qe[sl], "strand": crev[sl],
            "t_len": t_len[sl], "t_start": ts[sl], "t_end": te[sl],
            "matches": matches[sl], "block_len": span[sl],
        })
    return out


def map_query_arrays(
    index: MinimizerIndex,
    q_name: str,
    q_codes: np.ndarray,
    skip_self: bool = True,
):
    """Map one query against the index (block of one; see
    map_block_arrays)."""
    return map_block_arrays(index, [(q_name, q_codes)], skip_self)[0]


def map_query(
    index: MinimizerIndex,
    q_name: str,
    q_codes: np.ndarray,
    skip_self: bool = True,
) -> List[tuple]:
    """Map one query against the index; returns PAF-equivalent rows
    (q_name, t_name, numeric tuple matching OVERLAP_DTYPE order)."""
    m = map_query_arrays(index, q_name, q_codes, skip_self)
    if m is None:
        return []
    names = index.names()
    return [
        (
            q_name,
            names[m["tid"][i]],
            (
                m["q_len"], int(m["q_start"][i]), int(m["q_end"][i]),
                bool(m["strand"][i]), int(m["t_len"][i]),
                int(m["t_start"][i]), int(m["t_end"][i]),
                int(m["matches"][i]), int(m["block_len"][i]), 255,
            ),
        )
        for i in range(len(m["tid"]))
    ]


def _pile_from_arrays(q_name: str, m: dict, names: List[str],
                      max_support: int) -> Pile:
    n = len(m["tid"])
    ov = np.empty(n, dtype=OVERLAP_DTYPE)
    ov["q_len"] = m["q_len"]
    ov["q_start"] = m["q_start"]
    ov["q_end"] = m["q_end"]
    ov["strand"] = m["strand"]
    ov["t_len"] = m["t_len"]
    ov["t_start"] = m["t_start"]
    ov["t_end"] = m["t_end"]
    ov["matches"] = m["matches"]
    ov["block_len"] = m["block_len"]
    ov["mapq"] = 255
    order = np.argsort(-ov["matches"], kind="stable")[:max_support]
    tid = m["tid"]
    return Pile(
        q_name=q_name,
        t_names=[names[tid[i]] for i in order],
        ov=ov[order],
    )


def all_vs_all_piles(
    reads: Sequence[Tuple[str, np.ndarray]],
    params: OverlapParams = OverlapParams(),
    max_support: int = 150,
    n_workers: int | None = None,
) -> Iterator[Pile]:
    """Self-overlap piles for (name, codes) reads, query order =
    input order (the reference's PAF streaming order).

    Queries map in parallel on a thread pool (the numpy joins release
    the GIL) with a bounded in-flight window, so emission stays
    streaming-ordered — the host-side analogue of minimap2's -t
    (the reference's overlap stage is multithreaded too,
    CONSENT-correct:185)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    index = MinimizerIndex(params)
    for name, codes in reads:
        index.add(name, codes)
    index.build()
    names = index.names()

    def piles_of(block):
        ms = map_block_arrays(index, block, skip_self=True)
        return [
            None if m is None
            else _pile_from_arrays(nm, m, names, max_support)
            for (nm, _), m in zip(block, ms)
        ]

    nw = n_workers or os.cpu_count() or 1
    BLK = 64
    blocks = [reads[i : i + BLK] for i in range(0, len(reads), BLK)]
    if nw <= 1 or len(reads) < 8:
        for block in blocks:
            for p in piles_of(block):
                if p is not None:
                    yield p
        return
    import collections

    with ThreadPoolExecutor(max_workers=nw) as pool:
        # bounded in-flight window over BLOCKS: order-preserving AND
        # memory-bounded (an eager pool.map would buffer every pile
        # when the consumer lags).  The window is deep (~2 pipeline
        # chunks of piles) so overlap mapping keeps running in the
        # pool while the downstream pipeline chews on a chunk —
        # overlap and correction overlap end-to-end in the CLI.
        it = iter(blocks)
        futs: collections.deque = collections.deque()
        for block in list(__import__("itertools").islice(it, 32)):
            futs.append(pool.submit(piles_of, block))
        while futs:
            ps = futs.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                futs.append(pool.submit(piles_of, nxt))
            for p in ps:
                if p is not None:
                    yield p


# rows-in-RAM ceiling for the in-memory polish grouping path; above
# it the temp-PAF + external-sort streaming path takes over (the
# reference's own discipline, CONSENT-polish:192)
_INMEM_ROW_LIMIT = 5_000_000


def map_to_targets_piles(
    targets: Sequence[Tuple[str, np.ndarray]],
    reads: Sequence[Tuple[str, np.ndarray]],
    params: OverlapParams = OverlapParams(),
    max_support: int = 20000,
    tmpdir: str | None = None,
) -> Iterator[Pile]:
    """Polishing-shaped piles: for each *target* (contig), the overlaps
    of all reads mapped onto it, with the contig as the pile query —
    the role of minimap2 + sort + reformatPAF in the reference
    (CONSENT-polish:189-193).

    Small/medium runs group entirely in memory (read->contig row
    counts are tiny next to all-vs-all); when the row count passes
    _INMEM_ROW_LIMIT the original streaming discipline takes over:
    rows spill to a temp PAF tagged with the contig's input ordinal,
    an external stable sort(1) groups them (the reference's
    `sort -k6,6`, CONSENT-polish:192), and piles stream back."""
    import os

    index = MinimizerIndex(params)
    ordinal: Dict[str, int] = {}
    for name, codes in targets:
        index.add(name, codes)
        ordinal.setdefault(name, len(ordinal))
    index.build()
    names = index.names()

    def mapped(block):
        return map_block_arrays(index, block, skip_self=False)

    def all_mapped():
        """Block mapping fanned over a thread pool, order kept
        (block-wide numpy ops release the GIL — minimap2's -t
        analogue, like all_vs_all_piles)."""
        nw = os.cpu_count() or 1
        BLK = 64
        blocks = [reads[i : i + BLK] for i in range(0, len(reads), BLK)]
        if nw <= 1 or len(reads) < 8:
            for block in blocks:
                for (nm, _), m in zip(block, mapped(block)):
                    yield nm, m
            return
        import collections
        import itertools
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nw) as pool:
            it = iter(blocks)
            futs: collections.deque = collections.deque()
            for block in list(itertools.islice(it, 16)):
                futs.append((block, pool.submit(mapped, block)))
            while futs:
                block, fut = futs.popleft()
                ms = fut.result()
                nxt = next(it, None)
                if nxt is not None:
                    futs.append((nxt, pool.submit(mapped, nxt)))
                for (nm, _), m in zip(block, ms):
                    yield nm, m

    # ---- in-memory grouping (the default) ----
    # Collect per-read mapped arrays bucketed by contig ordinal; rows
    # keep read-emission order within each contig (stable grouping,
    # identical to the temp-PAF + stable-sort path).
    per_contig: List[list] = [[] for _ in targets]
    n_rows = 0
    spill = None
    for r_name, m in all_mapped():
        if m is None:
            continue
        n = len(m["tid"])
        n_rows += n
        for j in range(n):
            t = int(m["tid"][j])
            per_contig[t].append((r_name, m, j))
        if n_rows > _INMEM_ROW_LIMIT:
            spill = all_mapped  # row count too large: restart streaming
            break

    if spill is None:
        for t, bucket in enumerate(per_contig):
            if not bucket:
                continue
            n = len(bucket)
            ov = np.empty(n, dtype=OVERLAP_DTYPE)
            t_names = []
            for i, (r_name, m, j) in enumerate(bucket):
                # swap query<->target: the contig becomes the query
                ov["q_len"][i] = m["t_len"][j]
                ov["q_start"][i] = m["t_start"][j]
                ov["q_end"][i] = m["t_end"][j]
                ov["strand"][i] = m["strand"][j]
                ov["t_len"][i] = m["q_len"]
                ov["t_start"][i] = m["q_start"][j]
                ov["t_end"][i] = m["q_end"][j]
                ov["matches"][i] = m["matches"][j]
                ov["block_len"][i] = m["block_len"][j]
                ov["mapq"][i] = 255
                t_names.append(r_name)
            order = np.argsort(-ov["matches"], kind="stable")[:max_support]
            yield Pile(
                q_name=names[t],
                t_names=[t_names[i] for i in order],
                ov=ov[order],
            )
        return

    # ---- streaming fallback (huge row counts) ----
    import tempfile

    from consent_tpu_torch.io import paf as paf_mod

    tagged = tempfile.NamedTemporaryFile(
        "w", suffix=".paf.tag", delete=False, dir=tmpdir
    )
    sorted_path = tagged.name + ".sorted"
    try:
        with tagged as out:
            for r_name, m in all_mapped():
                if m is None:
                    continue
                for j in range(len(m["tid"])):
                    t = int(m["tid"][j])
                    # contig becomes the query; ends exclusive in PAF
                    # text (parse_line re-derives inclusive)
                    out.write(
                        f"{t}\t{names[t]}\t{m['t_len'][j]}\t"
                        f"{m['t_start'][j]}\t{m['t_end'][j] + 1}\t"
                        f"{'-' if m['strand'][j] else '+'}\t{r_name}\t"
                        f"{m['q_len']}\t{m['q_start'][j]}\t"
                        f"{m['q_end'][j] + 1}\t{m['matches'][j]}\t"
                        f"{m['block_len'][j]}\t255\n"
                    )
        if not paf_mod._external_sort(
            tagged.name, sorted_path, ["-k1,1n", "-s"], tmpdir=tmpdir
        ):
            # no sort(1): one in-RAM stable pass
            with open(tagged.name) as f:
                lines = sorted(
                    (ln for ln in f if ln.strip()),
                    key=lambda ln: int(ln.split("\t", 1)[0]),
                )
            with open(sorted_path, "w") as f:
                f.writelines(lines)
        os.unlink(tagged.name)
        with open(sorted_path) as f:
            yield from paf_mod.iter_piles(
                (line.split("\t", 1)[1] for line in f), max_support
            )
    finally:
        for p in (tagged.name, sorted_path):
            if os.path.exists(p):
                os.unlink(p)
