"""The plain reference of one job: the same piles, consensus, host post,
stitch and trim, worked out from the generated sequences alone.

It runs the frozen copies of the port's plain code (frozen/): the
minimizer overlapper in NumPy; the consensus with the aligner's plain
PyTorch version (the row-by-row fill the two CUDA kernels replace) and
the vote epilogue, assembled on the host; the host post in Python
(counts, anchors, solidity, the DBG repair: the steps the port's native
library runs in C++); the stitch with the plain full-width aligner and
the Python splice; the trim.  Nothing of the program is imported and
nothing it made is read.

`score_bits=8` runs every DP of the consensus and the stitch in int8,
one type below the int16 the configuration states: the control, which
the comparison has to reject.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gpubench.reference import npspans
from gpubench.reference.frozen import align
from gpubench.reference.frozen import consensus as cons
from gpubench.reference.frozen import dbg, kmer, postprocess
from gpubench.reference.frozen import minimizer as mz
from gpubench.reference.frozen import stitch
from gpubench.reference.frozen import windows as win
from gpubench.reference.frozen.config import ConsentConfig
from gpubench.reference.frozen.paf import Pile
from gpubench.reference.frozen.sparse_counts import SparseCounts

# the engine's fragment buckets and call cap (pipeline/engine.py)
S_BUCKETS = (4, 8, 16, 32, 64, 152)
MAX_B = 256


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


# ------------------------------------------------------------- overlap

def piles_correct(reads: Sequence[Tuple[str, np.ndarray]],
                  wanted: Sequence[str], max_support: int
                  ) -> Dict[str, Optional[Pile]]:
    """Self-overlap piles of the reads named in `wanted`, over an index
    of every read (None where a read has no pile)."""
    index = mz.MinimizerIndex(mz.OverlapParams())
    for name, codes in reads:
        index.add(name, codes)
    index.build()
    names = index.names()
    seqs = dict(reads)
    block = [(n, seqs[n]) for n in wanted]
    out = {}
    for (n, _), m in zip(block, mz.map_block_arrays(index, block,
                                                     skip_self=True)):
        out[n] = None if m is None else mz._pile_from_arrays(
            n, m, names, max_support)
    return out


def piles_polish(contigs: Sequence[Tuple[str, np.ndarray]],
                 reads: Sequence[Tuple[str, np.ndarray]],
                 wanted: Sequence[str], max_support: int
                 ) -> Dict[str, Optional[Pile]]:
    """The piles of the contigs named in `wanted`: every read mapped
    onto the contigs, the contig as the pile's query."""
    want = set(wanted)
    out: Dict[str, Optional[Pile]] = {n: None for n in wanted}
    for p in mz.map_to_targets_piles(contigs, reads, mz.OverlapParams(),
                                     max_support):
        if p.q_name in want:
            out[p.q_name] = p
    return out


# ------------------------------------------------------------- windows

@dataclasses.dataclass
class Task:
    pos: Tuple[int, int]
    frags: List[np.ndarray]
    d0s: Optional[List[int]]
    consensus: Optional[np.ndarray] = None
    solid: Optional[np.ndarray] = None
    counts: Optional[SparseCounts] = None


def windows_of_pile(pile: Pile, seqs: Dict[str, np.ndarray],
                    cfg: ConsentConfig) -> Optional[List[Task]]:
    seq_map = win.sequences_map(pile, seqs)
    q_len = len(seq_map[pile.q_name])
    cov = win.coverage(q_len, pile.ov)
    pos = win.window_positions(q_len, cov, cfg.min_support,
                               cfg.window_size, cfg.window_overlap)
    if not pos:
        return None
    tasks = []
    for beg, end in pos:
        frags, d0s = win.clip_fragments(pile, seq_map, beg, end,
                                        cfg.mer_size, with_offsets=True)
        tasks.append(Task((beg, end), frags, d0s))
    return tasks


# ----------------------------------------------------------- consensus

def _bucket(n: int, cap: int) -> int:
    for b in S_BUCKETS:
        if n <= b:
            return min(b, cap) if cap >= n else cap
    return cap


def consensus(tasks: List[Task], cfg: ConsentConfig, device,
              score_bits: int = 16, times: Optional[dict] = None) -> None:
    """Each window's consensus by the plain aligner and vote epilogue
    (every round), assembled on the host; then the host post."""
    times = {} if times is None else times
    scoring = align.Scoring(
        match=cfg.match_score, mismatch=cfg.mismatch_score,
        gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
        max_hgap=cfg.consensus_max_hgap, band=cfg.consensus_band,
        score_bits=score_bits)
    s_cap = max(S_BUCKETS[-1], cfg.max_msa + 1)
    Lf = _round_up(cfg.window_size, 128)
    Lt = _round_up(cfg.window_size + cfg.frag_slack, 128)
    buckets: Dict[int, List[Task]] = {}
    for t in tasks:
        n = min(len(t.frags), cfg.max_msa + 1)
        if n == 0 or len(t.frags[0]) == 0:
            t.consensus = np.empty(0, np.uint8)
            t.solid = np.empty(0, bool)
            t.counts = SparseCounts.from_dense(np.zeros(1, np.int32))
            continue
        buckets.setdefault(_bucket(n, s_cap), []).append(t)
    for S, ts in sorted(buckets.items()):
        max_b = max(1, min(cfg.device_lanes // S, MAX_B))
        for lo in range(0, len(ts), max_b):
            sub = ts[lo: lo + max_b]
            B = len(sub)
            frags = np.zeros((B, S, Lf), np.uint8)
            frag_len = np.zeros((B, S), np.int32)
            frag_d0 = np.zeros((B, S), np.int32)
            tpl = np.zeros((B, Lt), np.uint8)
            tpl_len = np.zeros(B, np.int32)
            for b, t in enumerate(sub):
                n_use = min(len(t.frags), cfg.max_msa + 1, S)
                for s, f in enumerate(t.frags[:n_use]):
                    L = min(len(f), Lf)
                    frags[b, s, :L] = f[:L]
                    frag_len[b, s] = L
                if t.d0s is not None:
                    frag_d0[b, :n_use] = t.d0s[:n_use]
                tp = t.frags[0]
                tpl[b, : len(tp)] = tp
                tpl_len[b] = len(tp)
            t0 = time.perf_counter()
            dev = [torch.from_numpy(x).to(device)
                   for x in (frags, frag_len, tpl, tpl_len, frag_d0)]
            votes, w_len = cons.consensus_votes_rounds(
                dev[0], dev[1], dev[2], dev[3], S=S,
                rounds=max(1, cfg.consensus_rounds),
                min_column_support=cfg.min_column_support, scoring=scoring,
                frag_d0=dev[4] if scoring.band else None,
                warm_frac=cfg.warm_frac)
            votes = cons.WindowVotes(*[v.cpu().numpy() for v in votes])
            assembled = cons.assemble_consensus_batch(
                votes, w_len.cpu().numpy().tolist())
            t1 = time.perf_counter()
            for b, t in enumerate(sub):
                host_post(t, assembled[b][:Lt], S, cfg)
            t2 = time.perf_counter()
            times["consensus"] = times.get("consensus", 0.0) + t1 - t0
            times["host_post"] = times.get("host_post", 0.0) + t2 - t1


def host_post(t: Task, cons_codes: np.ndarray, S: int,
              cfg: ConsentConfig) -> None:
    """Counts, the anchor gate, solidity and the DBG repair, in Python
    (the steps of engine._host_post_one with the Python versions)."""
    use = t.frags[: min(len(t.frags), cfg.max_msa + 1, S)]
    dense = kmer.count_kmers_host(use, cfg.mer_size)
    keys = np.flatnonzero(dense)
    sparse = SparseCounts(keys, dense[keys].astype(np.int32))
    support = min(cfg.common_kmers, len(use) // 2)
    if kmer.count_anchors_host(use, cfg.mer_size, support) < cfg.min_anchors:
        tpl = np.asarray(t.frags[0], dtype=np.uint8)
        t.consensus, t.solid, t.counts = tpl, np.ones(len(tpl), bool), sparse
        return
    if len(cons_codes) >= cfg.mer_size:
        solid = kmer.solidity_mask(cons_codes, dense, cfg.mer_size,
                                   cfg.solid_thresh)
        cons_codes, solid = dbg.polish_correction(
            cons_codes, solid, dense, cfg.mer_size, cfg.solid_thresh,
            cfg.max_branches, cfg.dbg_zone)
    else:
        solid = np.zeros(len(cons_codes), dtype=bool)
    t.consensus, t.solid, t.counts = cons_codes, solid, sparse


# -------------------------------------------------------------- stitch

STITCH = align.Scoring(match=stitch.STITCH_SCORING["match"],
                       mismatch=stitch.STITCH_SCORING["mismatch"],
                       gap_open=stitch.STITCH_SCORING["gap_open"],
                       gap_extend=stitch.STITCH_SCORING["gap_extend"])


def align_spans(qs: Sequence[np.ndarray], rs: Sequence[np.ndarray],
                fixed_len: int, device, score_bits: int = 16
                ) -> List[stitch.AlignSpan]:
    """Each (query, slab) pair's local-alignment span by the plain
    full-width aligner (its NumPy form, npspans.py, at the stated int16),
    padded as the port's span call pads them."""
    Lq = max(_round_up(max(len(q) for q in qs), 128), fixed_len)
    Lr = max(_round_up(max(len(r) for r in rs), 128), fixed_len)
    n = len(qs)
    q = np.zeros((n, Lq), np.uint8)
    r = np.zeros((n, Lr), np.uint8)
    for i, (a, b) in enumerate(zip(qs, rs)):
        q[i, : len(a)] = a
        r[i, : len(b)] = b
    ql = np.array([len(a) for a in qs], np.int32)
    rl = np.array([len(b) for b in rs], np.int32)
    if score_bits == 16:
        cols = npspans.spans(q, ql, r, rl, **stitch.STITCH_SCORING)
    else:
        t = [torch.from_numpy(x).to(device) for x in (q, ql, r, rl)]
        sc = STITCH._replace(score_bits=score_bits)
        s = align.summary_spans(align.posterior_summary(*t, sc))
        cols = [x.cpu().numpy() for x in (s.q_begin, s.q_end, s.r_begin,
                                          s.r_end, s.valid)]
    return [stitch.AlignSpan(int(cols[0][i]), int(cols[1][i]),
                             int(cols[2][i]), int(cols[3][i]),
                             bool(cols[4][i])) for i in range(n)]


def stitch_fixed_len(cfg: ConsentConfig) -> int:
    return _round_up(max(cfg.window_size + 2 * cfg.window_overlap,
                         cfg.window_size + cfg.frag_slack), 128)


def run_stitch(jobs: List[stitch.StitchJob], cfg: ConsentConfig, device,
               score_bits: int = 16) -> None:
    """Every job's windows in order, one aligned batch a round."""
    fixed = stitch_fixed_len(cfg)
    live = [j for j in jobs if not j.done]
    while live:
        reqs = [j.next_request() for j in live]
        spans = align_spans([q for q, _ in reqs], [r for _, r in reqs],
                            fixed, device, score_bits)
        for j, s in zip(live, spans):
            j.apply(s)
        live = [j for j in live if not j.done]


# ----------------------------------------------------------------- job

def correct_piles(piles: Dict[str, Optional[Pile]],
                  seqs: Dict[str, np.ndarray], cfg: ConsentConfig, device,
                  score_bits: int = 16, times: Optional[dict] = None
                  ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """(codes, solid) of each pile's query, as the pipeline yields it:
    empty where the read is dropped or has no window.  `times` gathers
    the seconds of each stage."""
    times = {} if times is None else times
    t0 = time.perf_counter()
    per: Dict[str, Optional[List[Task]]] = {}
    all_tasks: List[Task] = []
    for name, pile in piles.items():
        tasks = None if pile is None else windows_of_pile(pile, seqs, cfg)
        per[name] = tasks
        if tasks:
            all_tasks.extend(tasks)
    times["windows"] = time.perf_counter() - t0
    consensus(all_tasks, cfg, device, score_bits, times)
    t1 = time.perf_counter()
    jobs = {}
    for name, tasks in per.items():
        if tasks:
            jobs[name] = stitch.StitchJob(
                name=name, raw_codes=seqs[name],
                piles_pos=[t.pos for t in tasks],
                consensuses=[(t.consensus, t.solid) for t in tasks],
                templates=[t.frags[0] if t.frags else np.empty(0, np.uint8)
                           for t in tasks],
                counts=[t.counts for t in tasks], cfg=cfg)
    run_stitch(list(jobs.values()), cfg, device, score_bits)
    times["stitch"] = time.perf_counter() - t1
    out = {}
    for name in piles:
        job = jobs.get(name)
        if job is None:
            out[name] = (np.empty(0, np.uint8), np.empty(0, bool))
            continue
        codes, solid = job.result()
        if cfg.trim:
            codes, solid = postprocess.trim_read(codes, solid, 1)
            if postprocess.drop_read(solid):
                codes, solid = codes[:0], solid[:0]
        out[name] = (codes, solid)
    return out
