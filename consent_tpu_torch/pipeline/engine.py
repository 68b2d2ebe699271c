"""The per-read processing engine.

Orchestrates the full per-pile chain of the reference drivers:

  pile -> window positions -> fragment clipping -> [device] batched
  realign-vote consensus -> k-mer weighting -> DBG polish -> [device]
  batched stitch -> trim/drop.

Windows from *many* reads are pooled and bucketed by fragment count
into fixed-shape device batches; stitching runs reads in lockstep
rounds (pipeline/stitch.py).  Everything is deterministic: results are
emitted in input pile order.

The engine runs on a mesh of devices (parallel/mesh.py): "cuda" (the
default) is every local card, runs the CUDA kernels and raises when
there is no card; "cpu" runs the kernels' plain PyTorch versions.  On
the card every consensus call is a replay of CUDA graphs captured once
per shard shape (ops/graphs.py), as the JAX package jits it once per
static shape: on the data axis one graph per shard, over a frag axis a
chain of each shard's phase-A and phase-B graphs; `graphs=False` runs
the calls op by op instead, for comparison only.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import sys
import time
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from consent_tpu_torch.config import ConsentConfig
from consent_tpu_torch.core import dbg as dbg_mod
from consent_tpu_torch.core import postprocess, windows as win_mod
from consent_tpu_torch.core.sparse_counts import SparseCounts
from consent_tpu_torch.io.paf import Pile
from consent_tpu_torch.ops import consensus as cons_ops
from consent_tpu_torch.ops import graphs as graph_ops
from consent_tpu_torch.ops import kmer as kmer_ops
from consent_tpu_torch.ops.align import Scoring
from consent_tpu_torch.parallel import mesh as mesh_mod
from consent_tpu_torch.pipeline import stitch_rounds
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
    """Batched window-consensus executor over a mesh of devices.

    Devices are chosen as the JAX package chooses them: every local
    device by default (every card for "cuda"; `devices` names the list
    instead, which may repeat a device, as XLA's virtual host devices
    do in the JAX package's tests), n_devices of them at most, window
    batches split over the `data` axis, and fragment slots over a
    `frag` axis too when one window's slots (s_cap) exceed one device's
    lane budget (device_lanes) or frag_devices asks for it.

    On the card, every per-shard call shape `run` can dispatch
    (call_shapes) is captured when the engine is built, before any
    chain thread runs: on the data axis as a CUDA graph on each card of
    the mesh (a process captures each shape once per card), over a frag
    axis as each data row's frag chain (each shard's phase A and phase
    B, ops/graphs.py: FragChain); `graphs=False` keeps the calls
    eager."""

    def __init__(self, cfg: ConsentConfig, device="cuda", graphs=True,
                 devices: Optional[Sequence] = None):
        self.cfg = cfg
        if devices is None:
            resolve_device(device)      # raises without a card
            local = mesh_mod.local_devices(device)
        else:
            local = [resolve_device(d) for d in devices]
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
        # device parallelism: window batches split over a `data` axis
        # of the local devices; deep piles whose fragment slots exceed
        # one device's lane budget split the slots over a `frag` axis
        # too, the vote reductions summed over it (parallel/mesh.py)
        n_local = len(local)
        self.n_devices = min(cfg.n_devices or n_local, n_local)
        nf = cfg.frag_devices
        if nf is None:
            nf = (
                self.n_devices
                if self.s_cap > cfg.device_lanes and self.n_devices > 1
                else 1
            )
        self.frag_devices = max(1, min(nf, self.n_devices))
        self.mesh = mesh_mod.make_mesh(local[: self.n_devices],
                                       frag_axis=self.frag_devices)
        self.device = self.mesh.grid[0][0]
        self.max_lanes = cfg.device_lanes * self.n_devices
        self.rounds = max(1, cfg.consensus_rounds)
        self.graphs = graphs and self.device.type == "cuda"
        if self.graphs:
            self._capture_all()

    def call_shapes(self) -> Set[Tuple[int, int]]:
        """The per-shard (fragment slots, windows) of every device call
        `run` can make: each fragment bucket a window of 1 to
        max_msa + 1 fragments falls in, at its two batch sizes
        {tail_b, max_b}, split over the mesh."""
        nd, nf = self.mesh.shape
        shapes = set()
        for n in range(1, self.cfg.max_msa + 2):
            S = self._bucket(n)
            max_b = self._max_b(S)
            for B in (self._pad_b(1, max_b), max_b):
                shapes.add((S // nf, B // nd))
        return shapes

    def _bucket(self, n: int) -> int:
        """Fragment slots of a window with n fragments: its bucket,
        rounded up to equal frag shards."""
        b = _bucket_for(n, self.s_cap)
        nf = self.frag_devices
        return -(-b // nf) * nf

    def _wire_fn(self, S: int, rounds: int):
        cfg = self.cfg
        return functools.partial(
            cons_ops.consensus_votes_wire, S=S, Pb=self.Lf // 4, Lt=self.Lt,
            min_column_support=cfg.min_column_support, scoring=self.scoring,
            rounds=rounds, assemble_out=True, warm_frac=cfg.warm_frac,
        )

    def _captured(self, S: int, B: int, rounds: int, device=None):
        """The graph of one per-shard call shape on `device` (default:
        the mesh's first)."""
        cfg = self.cfg
        key = mesh_mod.wire_key(S, B, self.Lf // 4, self.Lt,
                                cfg.min_column_support, self.scoring, rounds,
                                True, cfg.warm_frac)
        row = S * (self.Lf // 4) + 4 * S + self.Lt + 4 + 4 * S
        return graph_ops.captured(key, self._wire_fn(S, rounds), (B, row),
                                  device or self.device)

    def _frag_call(self, S: int, B: int, rounds: int, d: int):
        """Data row d's frag chain for one per-shard call shape."""
        return mesh_mod.frag_call(self.mesh, d, S, B, self.Lf // 4, self.Lt,
                                  self.cfg.min_column_support, self.scoring,
                                  rounds, self.cfg.warm_frac)

    def _capture_all(self) -> None:
        g0 = graph_ops.stats()["graphs"]
        t0 = time.perf_counter()
        shapes = sorted(self.call_shapes())
        if self.frag_devices > 1:
            # one chain per data row and shape: every shard's graphs
            units = [functools.partial(self._frag_call, S, B, self.rounds, d)
                     for d in range(self.mesh.shape[0]) for S, B in shapes]
            where = f"{len(self.mesh.grid)} frag row(s) of {self.mesh.shape[1]}"
        else:
            units = [functools.partial(self._captured, S, B, self.rounds, dev)
                     for dev in self.mesh.distinct() for S, B in shapes]
            where = f"{len(self.mesh.distinct())} device(s)"
        for unit in units:
            unit()
        st = graph_ops.stats()
        new = st["graphs"] - g0
        if new:
            print(f"[consent_tpu_torch] captured {new} consensus graphs "
                  f"for {len(shapes)} call shapes on {where} in "
                  f"{time.perf_counter() - t0:.3f} s; graph pool bytes "
                  f"by card {st['pool_bytes']}, frag chains' static bytes "
                  f"{st['static_bytes']}", file=sys.stderr)

    @staticmethod
    def _round128(x: int) -> int:
        return (x + 127) // 128 * 128

    def run(self, tasks: Sequence[WindowTask]) -> None:
        """Compute consensus + counts + DBG polish for every task.

        All consensus_rounds refinement rounds run in ONE device call
        per batch (intermediate consensuses are assembled on the
        device), so each batch fetches its result exactly once.
        Batches run on the chain pool so one batch's upload, fetch and
        host post overlap other batches' device work; each is a task of
        `consensus.chain` (utils/observe.py: StageStats.task)."""
        buckets: Dict[int, List[WindowTask]] = {}
        for t in tasks:
            n = min(len(t.frags), self.cfg.max_msa + 1)
            if n == 0 or len(t.frags[0]) == 0:
                t.consensus = np.empty(0, np.uint8)
                t.solid = np.empty(0, bool)
                t.counts = SparseCounts.from_dense(
                    np.zeros(1, np.int32))
                continue
            buckets.setdefault(self._bucket(n), []).append(t)

        jobs: List[Tuple[List[WindowTask], int]] = []
        for S, ts in buckets.items():
            max_b = self._max_b(S)
            for lo in range(0, len(ts), max_b):
                jobs.append((ts[lo : lo + max_b], S))

        rounds = self.rounds
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
            chain = STATS.task("consensus.chain", self._job_chain)
            if pool is not None and len(jobs) > 1:
                futs.append(pool.submit(chain, sub, S, arrays, rounds))
            else:
                chain(sub, S, arrays, rounds)
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
        """Windows per device call for bucket S (a multiple of the
        data-axis size, so the shards are equal)."""
        d = self.mesh.shape[0]
        return max(d, min(self.max_lanes // S, MAX_B) // d * d)

    def _pad_b(self, n: int, max_b: int) -> int:
        """Window-batch sizes come from a TWO-point set per fragment
        bucket — {tail_b, max_b} — so the device sees few shapes."""
        d = self.mesh.shape[0]
        tail_b = min(d * -(-16 // d), max_b)  # >= 16, divisible by d
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
        over the mesh, enqueued: on the data axis each shard's rows go
        through the one-device call (a captured graph's replay on a
        card, the plain path on the CPU); over a frag axis the slots
        split too, on a card as replays of each row's frag chain.
        _fetch_cons waits for the result."""
        cfg = self.cfg
        if self.frag_devices > 1:
            # deep-pile geometry: fragment slots split over `frag`, the
            # vote reductions summed over it
            res = mesh_mod.sharded_consensus_step(
                self.mesh, frags, frag_len, tpl, tpl_len, S=S,
                min_column_support=cfg.min_column_support,
                scoring=self.scoring,
                frag_d0=frag_d0 if self.scoring.band else None,
                packed=True, frags_packed=True, rounds=rounds,
                assemble_out=True, warm_frac=cfg.warm_frac,
                graphs=self.graphs,
            )
            if self.graphs:
                return res                  # a Joined, not yet waited on
            cons, lens = res
            return graph_ops.Pending(torch.cat(
                [cons, cons_ops._bytes32(lens[:, None])], dim=1))
        buf = cons_ops.wire_encode_inputs(
            frags, frag_len, tpl, tpl_len, frag_d0
        )
        return mesh_mod.sharded_wire_step(
            self.mesh, buf, S=S, Pb=frags.shape[-1], Lt=self.Lt,
            min_column_support=cfg.min_column_support,
            scoring=self.scoring, rounds=rounds, assemble_out=True,
            warm_frac=cfg.warm_frac, graphs=self.graphs,
        )

    def _fetch_cons(self, pending):
        """-> list of per-window assembled consensus code arrays."""
        return cons_ops.wire_decode_cons(pending.result(), self.Lt)

    def _host_post(self, ts, S, cons_list):
        """Host post-processing: counts, anchor gate, weighting, DBG
        polish, in the native C++ library (step by step, with a Python
        DBG repair, for windows that fail its capacity checks).

        The native path runs whole window SLICES per ctypes call
        (host.cpp host_post_batch), fanned out over the shared
        `--nproc`-sized pool (the native calls release the GIL), each
        slice a task of `host_post`.  Counted: windows that took the
        per-window path after a capacity failure (`host_post.fallback`)
        and windows that kept their template at the anchor gate
        (`host_post.template_kept`)."""
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
                    status = np.zeros(hi - lo, dtype=np.int32)
                    res = native.host_post_batch_native(
                        uses[lo:hi], conss[lo:hi], sups[lo:hi],
                        cfg.mer_size, cfg.solid_thresh,
                        cfg.max_branches, cfg.dbg_zone,
                        cfg.min_anchors, status=status,
                    )
                    if res is None:  # capacity failure: per-window path
                        kept = sum(
                            self._host_post_one(ts[b], cons_list[b], S)
                            for b in range(lo, hi)
                        )
                        STATS.add("host_post.fallback", hi - lo)
                        STATS.add("host_post.template_kept", kept)
                        return
                    STATS.add("host_post.template_kept",
                              int(np.count_nonzero(status == 1)))
                    for b, (c, s, sp) in enumerate(res, lo):
                        ts[b].consensus = c
                        ts[b].solid = s
                        ts[b].counts = sp

                n = len(ts)
                task = STATS.task("host_post", run_slice)
                if pool is not None and n >= 16:
                    # ~4 slices per worker for DBG load balance
                    k = 4 * (cfg.n_workers or os.cpu_count() or 1)
                    step = max(1, -(-n // k))
                    spans = [
                        (lo, min(lo + step, n))
                        for lo in range(0, n, step)
                    ]
                    list(pool.map(task, spans))
                else:
                    task((0, n))
            else:
                kept = sum(self._host_post_one(t, cons_list[b], S)
                           for b, t in enumerate(ts))
                STATS.add("host_post.template_kept", kept)

    def _host_post_one(self, t, cons, S) -> bool:
        """One window's host post; True when it kept its template at
        the anchor gate."""
        cfg = self.cfg
        from consent_tpu_torch import native

        cons = cons[: self.Lt]
        use = t.frags[: min(len(t.frags), cfg.max_msa + 1, S)]
        # the WHOLE post chain (counts, anchor gate, solidity, DBG
        # polish) in one native call
        status = np.zeros(1, dtype=np.int32)
        one = native.host_post_window_native(
            use, cons, cfg.mer_size, cfg.solid_thresh,
            cfg.max_branches, cfg.dbg_zone, cfg.min_anchors,
            min(cfg.common_kmers, len(use) // 2), status=status,
        )
        if one is not None:
            t.consensus, t.solid, t.counts = one
            return bool(status[0] == 1)
        # an output capacity check failed: the chain step by step, with
        # the DBG repair in Python when the native one fails too
        dense, keys = native.count_kmers_sparse_native(use, cfg.mer_size)
        sparse = SparseCounts(keys, dense[keys].astype(np.int32))
        # MSA give-up gate (-c/-a): windows with fewer than
        # min_anchors anchor k-mers keep the raw template,
        # unweighted and unpolished (correctionMSA.cpp:31-36
        # returns piles[0], an uppercase = all-solid string).
        bmean_sup = min(cfg.common_kmers, len(use) // 2)
        n_anch = native.count_anchors_native(use, cfg.mer_size, bmean_sup)
        if n_anch < cfg.min_anchors:
            tpl_f = np.asarray(t.frags[0], dtype=np.uint8)
            t.consensus = tpl_f
            t.solid = np.ones(len(tpl_f), dtype=bool)
            t.counts = sparse
            return True
        if len(cons) >= cfg.mer_size:
            solid = kmer_ops.solidity_mask(
                cons, dense, cfg.mer_size, cfg.solid_thresh
            )
            res = native.polish_correction_native(
                cons, solid, dense, cfg.mer_size, cfg.solid_thresh,
                cfg.max_branches, cfg.dbg_zone,
            )
            if res is not None:
                cons, solid = res
            else:
                cons, solid = dbg_mod.polish_correction(
                    cons, solid, dense, cfg.mer_size, cfg.solid_thresh,
                    cfg.max_branches, cfg.dbg_zone,
                )
        else:
            # too short for weighting: reference skips weighting and
            # polish (correctionMSA.cpp:43-46); keep as weak
            solid = np.zeros(len(cons), dtype=bool)
        t.consensus = cons
        t.solid = solid
        t.counts = sparse
        return False


def _py_slice(start: np.ndarray, stop: np.ndarray, n: np.ndarray):
    """Elementwise bounds of `seq[start:stop]` for sequences of length
    n, resolved as Python resolves a slice (a negative bound counts from
    the end, both are clipped to [0, n]); returns (lo, hi), hi >= lo."""
    start = np.where(start < 0, start + n, start)
    stop = np.where(stop < 0, stop + n, stop)
    lo = np.minimum(np.maximum(start, 0), n)
    hi = np.minimum(np.maximum(stop, 0), n)
    return lo, np.maximum(hi, lo)


def clip_piles(piles: Sequence[Pile], seq_maps: Sequence[dict],
               poss: Sequence[Sequence[Tuple[int, int]]], mer_size: int):
    """Every window's fragments of several piles in one vectorised pass.

    Returns (frags, d0s, n_pairs) over the piles' windows in order (pile
    by pile, `poss[k]` as `win_mod.window_positions` gives them): the
    fragments and start offsets that `win_mod.clip_fragments(piles[k],
    seq_maps[k], beg, end, mer_size, with_offsets=True)` returns for each
    window, and the number of (window, overlap) pairs examined.  Only
    pairs whose query spans intersect are enumerated (admission implies
    intersection), so the extra memory is O(windows x depth).
    Admission, the clipping cases and the offsets are array arithmetic
    over those pairs; Python only slices the fragments kept.  Each '-'
    target is reverse-complemented once a pass, and every fragment is a
    view of its target or of that reverse complement."""
    n_win = [len(p) for p in poss]
    n_ov = [len(p.ov) for p in piles]
    wp = np.array([w for p in poss for w in p], dtype=np.int64).reshape(-1, 2)
    beg, end = wp[:, 0], wp[:, 1]
    wpile = np.repeat(np.arange(len(piles)), n_win)
    opile = np.repeat(np.arange(len(piles)), n_ov)
    tpl_len = np.array([len(m[p.q_name]) for p, m in zip(piles, seq_maps)],
                       dtype=np.int64)
    on_tpl = end < tpl_len[wpile]

    def field(name):
        return np.concatenate([p.ov[name] for p in piles])

    qs, qe = field("q_start"), field("q_end")

    # candidate pairs: windows sorted by (pile, start); for each overlap
    # those of its pile from the first whose running-max end reaches
    # q_start to the last starting at or before q_end; the pile index
    # scaled past every coordinate keeps the search inside the pile
    big = max(int(end.max(initial=0)), int(qs.max(initial=0)),
              int(qe.max(initial=0))) + 2
    key = wpile * big + beg
    order = np.argsort(key, kind="stable")
    reach = np.maximum.accumulate(wpile[order] * big + end[order])
    lo = np.searchsorted(reach, opile * big + np.maximum(qs, 0), "left")
    hi = np.searchsorted(key[order], opile * big + np.maximum(qe, -1),
                         "right")
    cnt = np.maximum(hi - lo, 0)
    n_pairs = int(cnt.sum())
    oi = np.repeat(np.arange(len(qs)), cnt)
    wi = order[lo[oi] + np.arange(n_pairs) - (np.cumsum(cnt) - cnt)[oi]]

    b, e = beg[wi], end[wi]
    w = e - b + 1
    q0, q1 = qs[oi], qe[oi]
    t0, t1 = field("t_start")[oi], field("t_end")[oi]
    t_len = field("t_len")[oi]
    strand = field("strand")
    minus = strand[oi]
    shift = np.where(b > q0, b - q0, 0)
    # admission (clip_fragments): the alignment reaches into the window
    # from the left, or covers or passes its right end
    admit = ((((q0 <= b) & (q1 > b)) | ((e <= q1) & (q0 < e)))
             & (t0 + shift <= t1) & on_tpl[wi])

    # the three live clipping cases and the dead branch (left & right);
    # a left clip already has shift 0
    left, right = b < q0, q1 < e
    t_beg = np.where(left, np.maximum(0, t0 - (q0 - b)), t0)
    t_end = np.where(right, np.minimum(t_len - 1, t1 + (e - q1)), t1)
    length = np.where(
        left & right, t_end - t_beg + 1,
        np.where(left,
                 np.minimum(w, np.minimum(t_len - 1, t_beg + w - 1)
                            - t_beg + 1),
                 np.where(right,
                          np.minimum(w, t_end - np.maximum(0, t_end - w + 1)
                                     + 1),
                          w)))

    # slab = seq[t_beg : t_end + 1]; fragment = slab[shift : shift + length],
    # taken from the reverse complement for '-'
    n_seq = np.fromiter(
        (len(m[t]) for p, m in zip(piles, seq_maps) for t in p.t_names),
        dtype=np.int64, count=len(qs))[oi]
    s_lo, s_hi = _py_slice(t_beg, t_end + 1, n_seq)
    f_lo, f_hi = _py_slice(shift, shift + length, s_hi - s_lo)
    f_len = f_hi - f_lo
    # admitted and long enough
    sel = np.flatnonzero(admit & (f_len >= mer_size))
    rows, wins = oi[sel], wi[sel]
    b, q0, t0, t1, shift, t_beg, t_end, minus = (
        x[sel] for x in (b, q0, t0, t1, shift, t_beg, t_end, minus))
    start = np.where(minus, n_seq[sel] - s_hi[sel], s_lo[sel]) + f_lo[sel]

    # window column of fragment base 0, through the overlap's span ratio
    tb0 = np.where(minus, t_end - shift, t_beg + shift)
    t_rel = np.where(minus, t1 - tb0, tb0 - t0)
    t_span = t1 - t0
    scale = np.where(t_span > 0, (q1[sel] - q0) / np.maximum(t_span, 1),
                     1.0)
    d0 = np.rint(q0 + t_rel * scale).astype(np.int64) - b

    # in window order, each window on its template led by the
    # template's slice (source key -1 - pile, offset 0), then its
    # fragments in pile row order (source key: the row)
    tw = np.flatnonzero(on_tpl)
    win_all = np.concatenate([wins, tw])
    key_all = np.concatenate([rows, -1 - wpile[tw]])
    emit = np.lexsort((key_all, win_all))
    key_all = key_all[emit]
    start_all = np.concatenate([start, beg[tw]])[emit]
    len_all = np.concatenate([f_len[sel], (end - beg + 1)[tw]])[emit]
    d0_all = np.concatenate([d0, np.zeros(len(tw), np.int64)])[emit]

    names = [t for p in piles for t in p.t_names]
    srcs: Dict[int, np.ndarray] = {
        -1 - k: m[p.q_name] for k, (p, m) in enumerate(zip(piles, seq_maps))}
    rc: Dict[int, np.ndarray] = {}
    for r in np.unique(rows).tolist():
        seq = seq_maps[opile[r]][names[r]]
        if strand[r]:
            if id(seq) not in rc:
                # codes are 0-3 (io/seqs.py): the complement is code ^ 3
                rc[id(seq)] = seq[::-1] ^ 3
            seq = rc[id(seq)]
        srcs[r] = seq
    flat = [srcs[k][a:a + n] for k, a, n in
            zip(key_all.tolist(), start_all.tolist(), len_all.tolist())]
    flat_d0 = d0_all.tolist()
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(win_all, minlength=len(wp)))]).tolist()
    frags = [flat[i:j] for i, j in zip(bounds, bounds[1:])]
    d0s = [flat_d0[i:j] for i, j in zip(bounds, bounds[1:])]
    return frags, d0s, n_pairs


def windows_of_piles(piles: Sequence[Pile], read_index, cfg: ConsentConfig,
                     first_key: int = 0) -> List[Optional[List[WindowTask]]]:
    """`windows_of_pile` for consecutive piles (read keys first_key,
    first_key + 1, ...): window positions pile by pile, then every
    window's fragments in one vectorised pass (`clip_piles`).  Counts
    the (window, overlap) pairs examined (`geometry.pairs`) and the
    support fragments emitted (`geometry.frags`)."""
    seq_maps, poss = [], []
    for pile in piles:
        seq_map = win_mod.sequences_map(pile, read_index)
        q_len = len(seq_map[pile.q_name])
        cov = win_mod.coverage(q_len, pile.ov)
        seq_maps.append(seq_map)
        poss.append(win_mod.window_positions(
            q_len, cov, cfg.min_support, cfg.window_size,
            cfg.window_overlap))
    frags, d0s, n_pairs = clip_piles(piles, seq_maps, poss, cfg.mer_size)
    STATS.add("geometry.pairs", n_pairs)
    STATS.add("geometry.frags", sum(max(len(f) - 1, 0) for f in frags))
    out: List[Optional[List[WindowTask]]] = []
    g = 0
    for k, pos in enumerate(poss):
        out.append([
            WindowTask(read_key=first_key + k, window_idx=i, pos=(beg, end),
                       frags=frags[g + i], d0s=d0s[g + i])
            for i, (beg, end) in enumerate(pos)] or None)
        g += len(pos)
    return out


def windows_of_pile(pile: Pile, read_index, cfg: ConsentConfig,
                    read_key: int) -> Optional[List[WindowTask]]:
    """Window positions + clipped fragments for one pile; None when the
    pile yields no window (the reference silently drops such
    reads/contigs)."""
    return windows_of_piles([pile], read_index, cfg, read_key)[0]


def process_piles(
    piles: Iterable[Pile],
    read_index,
    cfg: ConsentConfig,
    batch_align=None,
    chunk_reads: int = 1024,
    device="cuda",
    graphs: bool = True,
    devices: Optional[Sequence] = None,
) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Full pipeline over a pile stream, on `device` (every local card
    for "cuda") or on the explicit device list `devices`.

    Yields (name, codes, solid) per input pile, in order; dropped
    reads yield empty arrays (the caller skips empty output).  On the
    card the device calls replay captured graphs; graphs=False runs
    them op by op (for comparison only).  `batch_align`, the stitch's
    aligner, has FixedAligner's dispatch/collect protocol (by default a
    FixedAligner over the engine's devices).

    The calling thread's wall is split into five stages: `pipeline.pull`
    (each chunk pulled from `piles`; the first pile of all, the
    overlapper's index and first block, is `overlap.first_pile` inside
    it), `pipeline.wait_geometry` and `pipeline.wait_consensus` (waits on
    the two background slots), `pipeline.stitch` (a chunk's stitch and
    trim) and `pipeline.consumer` (the caller's time between outputs).
    """
    engine = ConsensusEngine(cfg, device=device, graphs=graphs,
                             devices=devices)
    if batch_align is None:
        from consent_tpu_torch.pipeline.device_align import FixedAligner

        batch_align = FixedAligner(cfg, device=engine.device, graphs=graphs,
                                   mesh=engine.mesh)

    def geometry_stage(chunk: List[Pile]):
        """Chunk stage 0: window geometry (pure host), its own pipeline
        slot so chunk k+2's geometry overlaps chunk k+1's consensus.
        The chunk is one geometry task, vectorised over its piles and
        run on this slot's own thread: the shared `work` pool is left
        to the host post's slices."""
        with STATS.timer("windows.geometry", len(chunk)):
            per_read = STATS.task("geometry", windows_of_piles)(
                chunk, read_index, cfg)
            all_tasks = [t for tasks in per_read if tasks for t in tasks]
        STATS.add("windows.total", len(all_tasks))
        return per_read, all_tasks

    def consensus_stage(geo):
        """Chunk stage 1: device consensus + host post."""
        per_read, all_tasks = geo
        engine.run(all_tasks)
        return per_read

    def stitch_outputs(chunk: List[Pile], per_read):
        """The chunk's stitch and trim: its jobs as one native table,
        driven in lockstep rounds on `batch_align`'s dispatch/collect
        (pipeline/stitch_rounds.py)."""
        keys = [key for key, tasks in enumerate(per_read) if tasks]
        with stitch_rounds.StitchTable.from_tasks(
                cfg, [read_index[chunk[key].q_name] for key in keys],
                [per_read[key] for key in keys]) as table:
            with STATS.timer("stitch.total", len(chunk)):
                table.run(batch_align)
            results = table.results()

        stitched = dict(zip(keys, results))
        outs = []
        for key, pile in enumerate(chunk):
            if key not in stitched:
                outs.append((pile.q_name, np.empty(0, np.uint8),
                             np.empty(0, bool)))
                continue
            codes, solid = stitched[key]
            if cfg.trim:
                codes, solid = postprocess.trim_read(codes, solid, 1)
                if postprocess.drop_read(solid):
                    codes, solid = codes[:0], solid[:0]
            outs.append((pile.q_name, codes, solid))
        return outs

    def stitch_stage(chunk: List[Pile], per_read):
        with STATS.timer("pipeline.stitch", len(chunk)):
            outs = stitch_outputs(chunk, per_read)
        # the caller's time between outputs, added once a chunk
        consumer, n = 0.0, 0
        try:
            for out in outs:
                t0 = time.perf_counter()
                yield out
                consumer += time.perf_counter() - t0
                n += 1
        finally:
            STATS.add_seconds("pipeline.consumer", consumer, n)

    from concurrent.futures import ThreadPoolExecutor

    def chunks():
        stream = iter(piles)
        with STATS.timer("overlap.first_pile"):
            head = list(itertools.islice(stream, 1))
        buf: List[Pile] = []
        for pile in itertools.chain(head, stream):
            buf.append(pile)
            if len(buf) >= chunk_reads:
                yield buf
                buf = []
        if buf:
            yield buf

    def pull(it):
        with STATS.timer("pipeline.pull"):
            return next(it, None)

    def wait(stage, fut):
        with STATS.timer(stage):
            return fut.result()

    # three-slot software pipeline over chunks:
    #   geometry(k+2)  ||  consensus(k+1)  ||  stitch(k)
    # Two background threads; output order is unchanged because
    # chunks are consumed and yielded in order.
    it = chunks()
    first = pull(it)
    if first is None:
        return
    with ThreadPoolExecutor(max_workers=1) as geo_pipe, \
            ThreadPoolExecutor(max_workers=1) as cons_pipe:
        cur = first
        geo_fut = geo_pipe.submit(geometry_stage, cur)
        nxt = pull(it)
        nxt_geo_fut = (
            geo_pipe.submit(geometry_stage, nxt)
            if nxt is not None else None
        )
        cons_fut = cons_pipe.submit(
            consensus_stage, wait("pipeline.wait_geometry", geo_fut))
        while True:
            per_read = wait("pipeline.wait_consensus", cons_fut)
            if nxt_geo_fut is not None:
                following = pull(it)
                geo_next = wait("pipeline.wait_geometry", nxt_geo_fut)
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
