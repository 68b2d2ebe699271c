"""The per-read processing engine.

Orchestrates the full per-pile chain of the reference drivers:

  pile -> window positions -> fragment clipping -> [device] batched
  realign-vote consensus -> k-mer weighting -> DBG polish -> [device]
  batched stitch -> trim/drop.

Windows from *many* reads are pooled and bucketed by fragment count
into fixed-shape device batches; stitching runs reads in lockstep
rounds (pipeline/stitch.py).  Everything is deterministic: results are
emitted in input pile order.

The engine runs on one explicit `device`: "cuda" (the default) runs
the CUDA kernels and raises when there is no card; "cpu" runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from consent_tpu_torch.config import ConsentConfig
from consent_tpu_torch.core import postprocess, windows as win_mod
from consent_tpu_torch.core.sparse_counts import SparseCounts
from consent_tpu_torch.io.paf import Pile
from consent_tpu_torch.ops import consensus as cons_ops
from consent_tpu_torch.ops.align import Scoring
from consent_tpu_torch.pipeline import stitch as stitch_mod
from consent_tpu_torch.pipeline.device_align import resolve_device
from consent_tpu_torch.utils.observe import GLOBAL_STATS as STATS

S_BUCKETS = (4, 8, 16, 32, 64, 152)
MAX_B = 256     # windows per device call cap


@dataclasses.dataclass
class WindowTask:
    """One window of one read, from clipping to polished consensus."""

    read_key: int
    window_idx: int
    pos: Tuple[int, int]
    frags: List[np.ndarray]          # template first
    d0s: Optional[List[int]] = None  # est. start column per fragment
    # filled by the engine:
    consensus: Optional[np.ndarray] = None
    solid: Optional[np.ndarray] = None
    counts: Optional[SparseCounts] = None


def _bucket_for(n: int, cap: int) -> int:
    for b in S_BUCKETS:
        if n <= b:
            return min(b, cap) if cap >= n else cap
    return cap


class ConsensusEngine:
    """Batched window-consensus executor on one device."""

    def __init__(self, cfg: ConsentConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scoring = Scoring(
            match=cfg.match_score,
            mismatch=cfg.mismatch_score,
            gap_open=cfg.gap_open,
            gap_extend=cfg.gap_extend,
            max_hgap=cfg.consensus_max_hgap,
            band=cfg.consensus_band,
        )
        # fragment slots cap: template + maxMSA support fragments
        # (deep -M raises it past the standard buckets)
        self.s_cap = max(S_BUCKETS[-1], cfg.max_msa + 1)
        self.Lf = self._round128(cfg.window_size)
        self.Lt = self._round128(cfg.window_size + cfg.frag_slack)
        if (cfg.n_devices or 1) > 1 or (cfg.frag_devices or 1) > 1:
            raise NotImplementedError(
                "consent_tpu_torch runs on one device: n_devices and "
                "frag_devices > 1 are not supported yet"
            )
        self.max_lanes = cfg.device_lanes

    @staticmethod
    def _round128(x: int) -> int:
        return (x + 127) // 128 * 128

    def run(self, tasks: Sequence[WindowTask]) -> None:
        """Compute consensus + counts + DBG polish for every task.

        All consensus_rounds refinement rounds run in ONE device call
        per batch (intermediate consensuses are assembled on the
        device), so each batch fetches its result exactly once.
        Batches run on the chain pool so one batch's upload, fetch and
        host post overlap other batches' device work."""
        buckets: Dict[int, List[WindowTask]] = {}
        for t in tasks:
            n = min(len(t.frags), self.cfg.max_msa + 1)
            if n == 0 or len(t.frags[0]) == 0:
                t.consensus = np.empty(0, np.uint8)
                t.solid = np.empty(0, bool)
                t.counts = SparseCounts.from_dense(
                    np.zeros(1, np.int32))
                continue
            b = _bucket_for(n, self.s_cap)
            buckets.setdefault(b, []).append(t)

        jobs: List[Tuple[List[WindowTask], int]] = []
        for S, ts in buckets.items():
            max_b = self._max_b(S)
            for lo in range(0, len(ts), max_b):
                jobs.append((ts[lo : lo + max_b], S))

        rounds = max(1, self.cfg.consensus_rounds)
        from consent_tpu_torch.utils.hostpool import host_pool

        # chains spend most of their time waiting on the device or on
        # the native host post (GIL released), so the chain pool
        # exceeds the core count
        n_chain = max(4, self.cfg.n_workers or os.cpu_count() or 1)
        pool = host_pool(n_chain, kind="chain")
        futs = []
        for sub, S in jobs:
            with STATS.timer("consensus.build_batch", len(sub)):
                arrays = self._build_arrays(sub, S)
            if pool is not None and len(jobs) > 1:
                futs.append(
                    pool.submit(self._job_chain, sub, S, arrays, rounds)
                )
            else:
                self._job_chain(sub, S, arrays, rounds)
        for f in futs:
            f.result()

    def _job_chain(self, sub, S, arrays, rounds):
        """Upload + device call -> one fetch -> host post per batch:
        the refinement rounds AND the final consensus assembly run
        inside the device call; the download is the 2-bit-packed
        consensus."""
        frags, frag_len, frag_d0, tpl, tpl_len = arrays
        with STATS.timer("consensus.dispatch", len(sub)):
            dev = self._dispatch(S, frags, frag_len, frag_d0, tpl,
                                 tpl_len, rounds)
        with STATS.timer("consensus.device_votes", len(sub)):
            cons_list = self._fetch_cons(dev)
        self._host_post(sub, S, cons_list)

    def _max_b(self, S: int) -> int:
        """Windows per device call for bucket S."""
        return max(1, min(self.max_lanes // S, MAX_B))

    def _pad_b(self, n: int, max_b: int) -> int:
        """Window-batch sizes come from a TWO-point set per fragment
        bucket — {tail_b, max_b} — so the device sees few shapes."""
        tail_b = min(16, max_b)
        if n <= tail_b:
            return tail_b
        return max_b

    def _build_arrays(self, ts, S):
        cfg = self.cfg
        B = self._pad_b(len(ts), self._max_b(S))
        frags = np.zeros((B, S, self.Lf), dtype=np.uint8)
        frag_len = np.zeros((B, S), dtype=np.int32)
        frag_d0 = np.zeros((B, S), dtype=np.int32)
        tpl = np.zeros((B, self.Lt), dtype=np.uint8)
        tpl_len = np.zeros(B, dtype=np.int32)
        for b, t in enumerate(ts):
            n_use = min(len(t.frags), cfg.max_msa + 1, S)
            use = t.frags[:n_use]
            for s, f in enumerate(use):
                L = min(len(f), self.Lf)
                frags[b, s, :L] = f[:L]
                frag_len[b, s] = L
            if t.d0s is not None:
                frag_d0[b, :n_use] = t.d0s[:n_use]
            tp = t.frags[0]
            tpl[b, : len(tp)] = tp
            tpl_len[b] = len(tp)
        # fragments travel 2-bit packed (4x fewer upload bytes); the
        # device unpacks before the kernel (cons_ops.unpack_bases)
        return (cons_ops.pack_bases_host(frags), frag_len, frag_d0,
                tpl, tpl_len)

    def _dispatch(self, S, frags, frag_len, frag_d0, tpl, tpl_len,
                  rounds=1):
        """One wire-format consensus call with all refinement rounds
        (one upload buffer in, one download buffer out); the result
        stays on the device until _fetch_cons."""
        cfg = self.cfg
        buf = cons_ops.wire_encode_inputs(
            frags, frag_len, tpl, tpl_len, frag_d0
        )
        return cons_ops.consensus_votes_wire(
            torch.from_numpy(buf).to(self.device), S=S,
            Pb=frags.shape[-1], Lt=self.Lt,
            min_column_support=cfg.min_column_support,
            scoring=self.scoring, rounds=rounds, assemble_out=True,
            warm_frac=cfg.warm_frac,
        )

    def _fetch_cons(self, dev):
        """-> list of per-window assembled consensus code arrays."""
        return cons_ops.wire_decode_cons(dev.cpu().numpy(), self.Lt)

    def _host_post(self, ts, S, cons_list):
        """Host post-processing: counts, anchor gate, weighting, DBG
        polish, in the native C++ library.

        The native path runs whole window SLICES per ctypes call
        (host.cpp host_post_batch), fanned out over the shared
        `--nproc`-sized pool (the native calls release the GIL)."""
        from consent_tpu_torch import native
        from consent_tpu_torch.utils.hostpool import host_pool

        cfg = self.cfg
        pool = host_pool(cfg.n_workers)
        with STATS.timer("consensus.kmer_dbg", len(ts)):
            if len(ts) >= 2:
                uses = [
                    t.frags[: min(len(t.frags), cfg.max_msa + 1, S)]
                    for t in ts
                ]
                sups = [
                    min(cfg.common_kmers, len(u) // 2) for u in uses
                ]
                conss = [c[: self.Lt] for c in cons_list]

                def run_slice(span):
                    lo, hi = span
                    res = native.host_post_batch_native(
                        uses[lo:hi], conss[lo:hi], sups[lo:hi],
                        cfg.mer_size, cfg.solid_thresh,
                        cfg.max_branches, cfg.dbg_zone,
                        cfg.min_anchors,
                    )
                    if res is None:  # capacity failure: per-window path
                        for b in range(lo, hi):
                            self._host_post_one(ts[b], cons_list[b], S)
                        return
                    for b, (c, s, sp) in enumerate(res, lo):
                        ts[b].consensus = c
                        ts[b].solid = s
                        ts[b].counts = sp

                n = len(ts)
                if pool is not None and n >= 16:
                    # ~4 slices per worker for DBG load balance
                    k = 4 * (cfg.n_workers or os.cpu_count() or 1)
                    step = max(1, -(-n // k))
                    spans = [
                        (lo, min(lo + step, n))
                        for lo in range(0, n, step)
                    ]
                    list(pool.map(run_slice, spans))
                else:
                    run_slice((0, n))
            else:
                for b, t in enumerate(ts):
                    self._host_post_one(t, cons_list[b], S)

    def _host_post_one(self, t, cons, S):
        cfg = self.cfg
        from consent_tpu_torch import native

        cons = cons[: self.Lt]
        use = t.frags[: min(len(t.frags), cfg.max_msa + 1, S)]
        # the WHOLE post chain (counts, anchor gate, solidity, DBG
        # polish) in one native call
        one = native.host_post_window_native(
            use, cons, cfg.mer_size, cfg.solid_thresh,
            cfg.max_branches, cfg.dbg_zone, cfg.min_anchors,
            min(cfg.common_kmers, len(use) // 2),
        )
        if one is None:
            raise RuntimeError(
                "native host_post_window failed (output capacity); the "
                "Python host fallback is not ported"
            )
        t.consensus, t.solid, t.counts = one


def windows_of_pile(pile: Pile, read_index, cfg: ConsentConfig,
                    read_key: int) -> Optional[List[WindowTask]]:
    """Window positions + clipped fragments for one pile; None when the
    pile yields no window (the reference silently drops such
    reads/contigs)."""
    seq_map = win_mod.sequences_map(pile, read_index)
    q_len = len(seq_map[pile.q_name])
    cov = win_mod.coverage(q_len, pile.ov)
    pos = win_mod.window_positions(
        q_len, cov, cfg.min_support, cfg.window_size, cfg.window_overlap
    )
    if not pos:
        return None
    tasks = []
    for w_idx, (beg, end) in enumerate(pos):
        frags, d0s = win_mod.clip_fragments(
            pile, seq_map, beg, end, cfg.mer_size, with_offsets=True
        )
        tasks.append(
            WindowTask(read_key=read_key, window_idx=w_idx,
                       pos=(beg, end), frags=frags, d0s=d0s)
        )
    return tasks


def process_piles(
    piles: Iterable[Pile],
    read_index,
    cfg: ConsentConfig,
    batch_align=None,
    chunk_reads: int = 1024,
    device="cuda",
) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Full pipeline over a pile stream, on `device`.

    Yields (name, codes, solid) per input pile, in order; dropped
    reads yield empty arrays (the caller skips empty output).
    """
    engine = ConsensusEngine(cfg, device=device)
    if batch_align is None:
        from consent_tpu_torch.pipeline.device_align import FixedAligner

        batch_align = FixedAligner(cfg, device=engine.device)

    def geometry_stage(chunk: List[Pile]):
        """Chunk stage 0: window geometry (pure host), its own pipeline
        slot so chunk k+2's geometry overlaps chunk k+1's consensus."""
        from consent_tpu_torch.utils.hostpool import host_pool

        all_tasks: List[WindowTask] = []
        per_read: List[Optional[List[WindowTask]]] = []
        with STATS.timer("windows.geometry", len(chunk)):
            pool = host_pool(cfg.n_workers, kind="work")
            if pool is not None and len(chunk) >= 8:
                per_read = list(
                    pool.map(
                        lambda kp: windows_of_pile(
                            kp[1], read_index, cfg, kp[0]
                        ),
                        enumerate(chunk),
                    )
                )
            else:
                per_read = [
                    windows_of_pile(pile, read_index, cfg, key)
                    for key, pile in enumerate(chunk)
                ]
            for tasks in per_read:
                if tasks:
                    all_tasks.extend(tasks)
        STATS.add("windows.total", len(all_tasks))
        return per_read, all_tasks

    def consensus_stage(geo):
        """Chunk stage 1: device consensus + host post."""
        per_read, all_tasks = geo
        engine.run(all_tasks)
        return per_read

    def stitch_stage(chunk: List[Pile], per_read):
        jobs: List[Optional[stitch_mod.StitchJob]] = []
        for key, pile in enumerate(chunk):
            tasks = per_read[key]
            if not tasks:
                jobs.append(None)
                continue
            raw = read_index[pile.q_name]
            job = stitch_mod.StitchJob(
                name=pile.q_name,
                raw_codes=raw,
                piles_pos=[t.pos for t in tasks],
                consensuses=[(t.consensus, t.solid) for t in tasks],
                templates=[
                    t.frags[0] if t.frags else np.empty(0, np.uint8)
                    for t in tasks
                ],
                counts=[t.counts for t in tasks],
                cfg=cfg,
            )
            jobs.append(job)
        with STATS.timer("stitch.total", len(chunk)):
            stitch_mod.run_stitch(
                [j for j in jobs if j is not None], batch_align
            )

        for pile, job in zip(chunk, jobs):
            if job is None:
                yield pile.q_name, np.empty(0, np.uint8), np.empty(0, bool)
                continue
            codes, solid = job.result()
            if cfg.trim:
                codes, solid = postprocess.trim_read(codes, solid, 1)
                if postprocess.drop_read(solid):
                    codes, solid = codes[:0], solid[:0]
            yield pile.q_name, codes, solid

    from concurrent.futures import ThreadPoolExecutor

    def chunks():
        buf: List[Pile] = []
        for pile in piles:
            buf.append(pile)
            if len(buf) >= chunk_reads:
                yield buf
                buf = []
        if buf:
            yield buf

    # three-slot software pipeline over chunks:
    #   geometry(k+2)  ||  consensus(k+1)  ||  stitch(k)
    # Two background threads; output order is unchanged because
    # chunks are consumed and yielded in order.
    it = chunks()
    first = next(it, None)
    if first is None:
        return
    with ThreadPoolExecutor(max_workers=1) as geo_pipe, \
            ThreadPoolExecutor(max_workers=1) as cons_pipe:
        cur = first
        geo_fut = geo_pipe.submit(geometry_stage, cur)
        nxt = next(it, None)
        nxt_geo_fut = (
            geo_pipe.submit(geometry_stage, nxt)
            if nxt is not None else None
        )
        cons_fut = cons_pipe.submit(consensus_stage, geo_fut.result())
        while True:
            per_read = cons_fut.result()
            if nxt_geo_fut is not None:
                following = next(it, None)
                geo_next = nxt_geo_fut.result()
                nxt_geo_fut = (
                    geo_pipe.submit(geometry_stage, following)
                    if following is not None else None
                )
                cons_fut = cons_pipe.submit(consensus_stage, geo_next)
            else:
                following = None
                cons_fut = None
            yield from stitch_stage(cur, per_read)
            if cons_fut is None:
                return
            cur, nxt = nxt, following
