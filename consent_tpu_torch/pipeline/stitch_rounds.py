"""A chunk's stitch jobs in one native table, driven in lockstep rounds.

The same stitch as `stitch.run_stitch` over `stitch.StitchJob`s, on an
aligner with the dispatch/collect protocol (`device_align.FixedAligner`
and wrappers of it): the jobs' inputs and evolving state live in
`native/stitch_rounds.cpp`, and a group round is two GIL-free native
calls on the calling thread, whatever the number of jobs, beside the
aligner's dispatch and collect:

  requests  the live jobs' (query, slab) pairs into compact blobs, handed
            to the aligner as `device_align.Pairs`;
  apply     the collected [n, 5] spans through host.cpp's
            `stitch_apply_step`, the jobs advanced and the finished ones
            dropped from the group.

The grouping and the dispatch/collect interleave are `run_stitch`'s, and
each job's output bytes are the same: a job's stitch depends on nothing
else in the round, and a span on nothing but its own pair.

Spans: `stitch.align` (requests, dispatch and collect; the lanes counted
at collect), `stitch.apply` (the native apply, one count a live job).
Counters: `stitch.rounds_native` (group rounds), `stitch.windows_native`
(windows the native apply advanced).
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from consent_tpu_torch import native
from consent_tpu_torch.config import ConsentConfig
from consent_tpu_torch.core.sparse_counts import SparseCounts
from consent_tpu_torch.pipeline.device_align import MAX_LANES_PER_CALL, Pairs
from consent_tpu_torch.pipeline.stitch import STITCH_SCORING
from consent_tpu_torch.utils.observe import GLOBAL_STATS as STATS

_U8 = np.dtype(np.uint8)
_BOOL = np.dtype(bool)
_I64 = np.dtype(np.int64)
_I32 = np.dtype(np.int32)


class StitchTable:
    """Stitch jobs, one per read or contig, in a native table: the jobs'
    inputs gathered once, then `run`, then `results`; `close` (or the
    end of a `with` block) frees the table.

    Inputs are flat over all windows, job j's windows win_off[j] ..
    win_off[j + 1] - 1: each window's start (`pos0`), consensus, solid
    mask and SparseCounts.  A window's query is its consensus, or its
    template (`template(w)`), all solid, when the consensus is shorter
    than `mer_size` (StitchJob.next_request).  Each window's arrays are
    read in place: the table keeps them."""

    def __init__(self, cfg: ConsentConfig, raws: Sequence[np.ndarray],
                 win_off: np.ndarray, pos0: np.ndarray,
                 cons: Sequence[np.ndarray], solid: Sequence[np.ndarray],
                 counts: Sequence[SparseCounts],
                 template: Callable[[int], np.ndarray]):
        self.lib = lib = native.get_lib()
        n_jobs, n_win = len(raws), len(cons)
        self.n_jobs = n_jobs
        self.n_windows = np.diff(np.asarray(win_off, dtype=np.int64))
        k = cfg.mer_size

        raw_cons_len = np.fromiter(map(len, cons), np.int64, n_win)
        qs, ss = list(cons), list(solid)
        for w in np.flatnonzero(raw_cons_len < k):
            qs[w] = template(int(w))
            ss[w] = np.ones(len(qs[w]), dtype=bool)
        raw_off = np.zeros(n_jobs + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, raws), np.int64, n_jobs),
                  out=raw_off[1:])
        # each window's arrays are read in place, by address (kept alive
        # here): a window costs an id() an array, no ctypes object
        self.arrays = [_contiguous(qs, _U8), _contiguous(ss, _BOOL),
                       _contiguous([c.kmers for c in counts], _I64),
                       _contiguous([c.counts for c in counts], _I32)]
        ids = [_nonempty(np.fromiter(map(id, a), np.uint64, n_win))
               for a in self.arrays]
        q_len = np.fromiter(map(len, qs), np.int64, n_win)
        n_keys = np.fromiter(map(len, self.arrays[2]), np.int64, n_win)
        self.max_q = int(q_len.max()) if n_win else 0
        self.size_al = cfg.window_size + 2 * cfg.window_overlap
        self.ptr = lib.sr_new(
            n_jobs, np.ascontiguousarray(win_off, dtype=np.int64),
            _blob(raws), raw_off,
            ids[0], ids[1], _nonempty(q_len), _nonempty(raw_cons_len),
            _nonempty(np.ascontiguousarray(pos0, np.int64)),
            ids[2], ids[3], _nonempty(n_keys), _data_offset(),
            k, cfg.solid_thresh,
            STITCH_SCORING["match"], STITCH_SCORING["mismatch"],
            STITCH_SCORING["gap_open"], STITCH_SCORING["gap_extend"],
            cfg.window_size, cfg.window_overlap,
        )

    def close(self) -> None:
        if self.ptr:
            self.lib.sr_free(self.ptr)
            self.ptr = None
            self.arrays = None

    def __enter__(self) -> "StitchTable":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @classmethod
    def from_tasks(cls, cfg: ConsentConfig, raws: Sequence[np.ndarray],
                   per_job: Sequence[Sequence]) -> "StitchTable":
        """From each job's engine WindowTasks, with their consensus,
        solid mask and counts filled."""
        tasks = [t for ts in per_job for t in ts]
        win_off = np.zeros(len(per_job) + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, per_job), np.int64, len(per_job)),
                  out=win_off[1:])

        def template(w):
            frags = tasks[w].frags
            return frags[0] if frags else np.empty(0, np.uint8)

        return cls(
            cfg, raws, win_off,
            np.fromiter((t.pos[0] for t in tasks), np.int64, len(tasks)),
            [t.consensus for t in tasks], [t.solid for t in tasks],
            [t.counts for t in tasks], template,
        )

    # ---- the lockstep rounds ----

    def requests(self, ids: np.ndarray) -> Pairs:
        """Jobs `ids`' next (query, slab) pairs, in one native call."""
        n = len(ids)
        q_rows = np.empty(max(1, n * self.max_q), dtype=np.uint8)
        r_rows = np.empty(max(1, n * self.size_al), dtype=np.uint8)
        off = np.empty((4, n), dtype=np.int64)
        rc = self.lib.sr_requests(self.ptr, ids, n, q_rows, q_rows.size,
                                  off[0], off[1], r_rows, r_rows.size,
                                  off[2], off[3])
        if rc != 0:
            raise RuntimeError("sr_requests: a capacity is short")
        return Pairs(q_rows, off[0], off[1], r_rows, off[2], off[3])

    def run(self, batch_align) -> None:
        """Every job to its end, in groups of lockstep rounds on
        `batch_align`'s dispatch/collect (groups as run_stitch makes
        them)."""
        live = np.flatnonzero(self.n_windows > 0).astype(np.int64)
        n = len(live)
        if n == 0:
            return
        if n < 8:
            G = 1           # run_stitch's single lockstep batch
        else:
            G = max(2, min(4, n // 8))
            G = max(G, -(-n // MAX_LANES_PER_CALL))
        groups = [np.ascontiguousarray(live[g::G]) for g in range(G)]
        dispatch, collect = batch_align.dispatch, batch_align.collect

        def send(ids):
            # lanes are billed at collect (run_stitch's convention)
            with STATS.timer("stitch.align", 0):
                return dispatch(*self.requests(ids).sides())

        handles: List[Optional[tuple]] = [send(ids) for ids in groups]
        n_open = G
        while n_open:
            for g in range(G):
                if handles[g] is None:
                    continue
                ids = groups[g]
                with STATS.timer("stitch.align", len(ids)):
                    spans = collect(handles[g])
                with STATS.timer("stitch.apply", len(ids)):
                    groups[g] = ids = self.apply(ids, spans.rows)
                STATS.add("stitch.rounds_native")
                if len(ids):
                    handles[g] = send(ids)
                else:
                    handles[g] = None
                    n_open -= 1

    def apply(self, ids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Apply one round's spans, [n, 5] int32 rows, to jobs `ids`, the
        round's requests; returns the jobs with windows left, in order."""
        n = len(ids)
        rows = np.ascontiguousarray(rows[:n], dtype=np.int32)
        live = self.lib.sr_apply(self.ptr, ids, n, rows.reshape(-1))
        if live < 0:
            raise RuntimeError("sr_apply: a splice outgrew its capacity")
        STATS.add("stitch.windows_native", n)
        return ids[:live]

    def results(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Each job's (codes, solid), copied out of the table once."""
        n = self.n_jobs
        lens = np.empty(max(1, n), dtype=np.int64)
        self.lib.sr_results(self.ptr, lens, None, None, None)
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens[:n], out=off[1:])
        codes = np.empty(max(1, int(off[n])), dtype=np.uint8)
        solid = np.empty_like(codes)
        self.lib.sr_results(self.ptr, lens, off.ctypes.data,
                            codes.ctypes.data, solid.ctypes.data)
        solid = solid.view(bool)
        return [(codes[off[j] : off[j + 1]], solid[off[j] : off[j + 1]])
                for j in range(n)]


def _blob(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """uint8 arrays end to end (at least one byte, for the pointer)."""
    out = np.concatenate(arrays) if len(arrays) else np.zeros(0, _U8)
    return out.astype(_U8, copy=False) if len(out) else np.zeros(1, _U8)


def _contiguous(arrays: List[np.ndarray], dtype) -> List[np.ndarray]:
    """The arrays, each 1-D, C-contiguous and of `dtype` (copies of
    those that are not)."""
    want = (dtype, (dtype.itemsize,))
    if {(a.dtype, a.strides) for a in arrays} <= {want}:
        return arrays
    return [np.ascontiguousarray(a, dtype=dtype).reshape(-1)
            for a in arrays]


def _data_offset() -> int:
    """Where an ndarray object holds its data pointer: right after the
    object header (PyArrayObject_fields.data), checked on one array."""
    off = object.__basicsize__
    probe = np.zeros(1, dtype=np.int64)
    if ctypes.c_void_p.from_address(id(probe) + off).value \
            != probe.ctypes.data:
        raise RuntimeError("numpy arrays do not hold their data pointer "
                           "after the object header")
    return off


def _nonempty(a: np.ndarray) -> np.ndarray:
    return a if len(a) else np.zeros(1, dtype=a.dtype)
