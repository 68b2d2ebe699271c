"""Captured device calls: the port's counterpart of `jax.jit`.

The JAX package compiles each device call of the main path once per
static shape and then runs it as one program: the consensus call
(`consensus_votes_wire`, jitted with static S, Pb, Lt, rounds and the
scoring) and the stitch's span call (jitted with static Lq and Lr).
Run eagerly, the port's counterparts issue hundreds of torch ops per
call from the engine's chain threads, under the GIL.  Here each call is
captured once per static key as a `torch.cuda.CUDAGraph` and replayed
on every later call with that key (`captured`).

A captured call owns a static input (the wire buffer) and, in the
graph's memory, its output.  One call does three things in stream order
on the device's work stream, under the process-wide device lock:

  1. stage the host buffer in pinned memory and copy it into the static
     input (non-blocking);
  2. replay the graph;
  3. copy the output into a pinned host buffer and record an event.

The lock is held only while these are enqueued; the caller waits on the
event outside it (`Pending.result`).  Pinned buffers come from
PyTorch's caching host allocator, which hands a block out again only
after the events of the copies that used it have completed.

Streams.  All consensus and stitch work of a device runs on one work
stream (PyTorch creates its streams non-blocking), so none of it
touches the legacy default stream, whose implicit synchronisation
would invalidate a capture, and the calls keep one stream's order.
A capture runs on a second stream of the device, under the same lock,
in thread-local capture mode: a chain thread that waits on an event or
frees a tensor while another thread captures is neither an error nor
part of the capture.  Before its capture a call runs once eagerly
(warm-up), so that every kernel module is loaded and every launch
attribute set; the warm-up's launches are launches and count.

Memory.  The graphs of a device share one memory pool.  That is safe
because replays never overlap: every replay is enqueued on the
device's one work stream, under the lock, so a graph's intermediates
may reuse another graph's memory; each graph's static output stays
referenced and is never handed out again.

Launch counts.  ops/cuda_align.py counts a launch when its wrapper
runs.  A capture runs the wrappers once and launches nothing, so its
launches are recorded (`cuda_align.recording`) and added to the counts
on every replay.

Meshes.  A call split over the shards of a mesh (parallel/mesh.py)
replays the captured call of each shard's shape on the shard's own card.
On the data axis two shards on one card share that call, and that is
safe: each replay and the copy of its output to the host are enqueued
together, under the lock, on the card's one work stream, so the second
replay overwrites the static output only after the first one's copy has
read it.

The frag axis.  A call whose fragment slots are split over a data row's
shards is a chain (`FragChain`), the counterpart of the JAX package's
jit(shard_map) with its psum: per round, each shard's phase A is a
graph; the partials of the row's other shards are copied to the first
shard and summed there in shard order, in that shard's phase-B graph;
the sums are copied back, and each other shard's phase B (the next
template) is a graph; the last round's phase B, on the first shard only,
packs the consensus.  The chain keeps state from one replay to the next
(partials, sums, templates), so every tensor a later replay reads is a
static tensor allocated outside the graph pool (an earlier graph's
intermediates may share pool memory with anything a later capture
allocates) and stays referenced; each graph ends by copying its results
into them.  A chain is keyed by its data row and its devices, so two
shards on one card hold separate state, and its whole call (staging in,
every replay and copy, staging out) is enqueued under the lock as one
unit.  Copies between cards run outside the graphs, as torch copies
between two cards whose work streams are current: each waits for the
receiver's stream and the sender's, and the receiver's stream waits for
the copy; the host never waits.  Two shards of one card read each
other's static tensors directly, with no copy.

On the CPU nothing is captured: the callers run their plain path.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from consent_tpu_torch.ops import consensus as cons_ops
from consent_tpu_torch.ops import cuda_align
from consent_tpu_torch.utils.observe import GLOBAL_STATS as STATS

# the process-wide lock under which device calls are enqueued and
# graphs captured
_LOCK = threading.RLock()
_streams: Dict[int, Tuple["torch.cuda.Stream", "torch.cuda.Stream"]] = {}
_pools: Dict[int, tuple] = {}
_calls: Dict[tuple, "CapturedCall"] = {}


def _index(device) -> int:
    """The card's index.  It is never read from the current device: the
    pipeline's devices (resolve_device, parallel/mesh.py) always carry
    their index, so every shard of a mesh keys its own card's streams,
    pool and captured calls whichever thread enqueues it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"captured calls run on CUDA devices, not {dev}")
    if dev.index is None:
        raise ValueError(f"captured calls need an indexed device, not {dev}")
    return dev.index


def streams(device) -> Tuple["torch.cuda.Stream", "torch.cuda.Stream"]:
    """(work stream, capture stream) of a CUDA device."""
    idx = _index(device)
    with _LOCK:
        pair = _streams.get(idx)
        if pair is None:
            pair = (torch.cuda.Stream(idx), torch.cuda.Stream(idx))
            _streams[idx] = pair
        return pair


def work_stream(device) -> "torch.cuda.Stream":
    """The stream every consensus and stitch call of the device runs on."""
    return streams(device)[0]


@contextlib.contextmanager
def work_streams(devices: Sequence[torch.device]):
    """Every card of `devices` with its work stream current (a copy
    between two cards orders itself after the current streams of both)."""
    with contextlib.ExitStack() as stack:
        for dev in dict.fromkeys(torch.device(d) for d in devices):
            if dev.type == "cuda":
                stack.enter_context(torch.cuda.stream(work_stream(dev)))
        yield


def pool_handle(device) -> tuple:
    """The memory pool the device's graphs share."""
    idx = _index(device)
    with _LOCK:
        pool = _pools.get(idx)
        if pool is None:
            pool = _pools[idx] = torch.cuda.graph_pool_handle()
        return pool


def pool_segments(device) -> List[Tuple[int, int]]:
    """(address, bytes) of each segment of the device's graph pool."""
    idx = _index(device)
    pool = _pools.get(idx)
    if pool is None:
        return []
    return [(seg["address"], seg["total_size"])
            for seg in torch.cuda.memory_snapshot()
            if seg["device"] == idx
            and tuple(seg["segment_pool_id"]) == tuple(pool)]


class Pending:
    """A result on its way to the host: a host tensor, and the event
    recorded after the copy into it (None when it is already there)."""

    def __init__(self, host: torch.Tensor, event=None):
        self._host = host
        self._event = event

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class Joined:
    """The results of a call split by rows over shards, in shard order:
    one Pending per shard, joined along the rows on the host."""

    def __init__(self, parts: Sequence[Pending]):
        self.parts = list(parts)

    def result(self) -> np.ndarray:
        return np.concatenate([p.result() for p in self.parts], axis=0)


def _stage_in(buf: np.ndarray, dst: torch.Tensor) -> None:
    pinned = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[...] = buf
    dst.copy_(pinned, non_blocking=True)


def _stage_out(src: torch.Tensor, stream) -> Pending:
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return Pending(host, event)


def run_eager(fn: Callable[[torch.Tensor], torch.Tensor], buf: np.ndarray,
              device) -> Pending:
    """fn on the card op by op, with the captured calls' staging on the
    same work stream: the eager counterpart a caller gets only by
    asking for it (graphs=False)."""
    work = work_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(work):
        x = torch.empty(buf.shape, dtype=torch.uint8, device=device)
        _stage_in(buf, x)
        return _stage_out(fn(x), work)


class CapturedCall:
    """fn: uint8 [in_shape] device tensor -> device tensor, captured once
    on a static input and replayed on every call."""

    n_graphs = 1

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 in_shape: Sequence[int], device):
        self.fn = fn
        self.in_shape = tuple(int(n) for n in in_shape)
        self.device = torch.device(device)
        self.launches: List[Tuple[str, int]] = []
        self.capture_s = 0.0
        self.replays = 0
        self.static_in: Optional[torch.Tensor] = None
        self.static_out: Optional[torch.Tensor] = None
        self._graph = None

    def capture(self) -> None:
        t0 = time.perf_counter()
        with _LOCK:
            self._warm_up()
            with cuda_align.recording() as rec:
                self._graph, self.static_out = self._capture_graph()
            self.launches = list(rec)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, buf: np.ndarray) -> Pending:
        if tuple(buf.shape) != self.in_shape:
            raise ValueError(f"captured call takes {self.in_shape}, got "
                             f"{tuple(buf.shape)}")
        with _LOCK:
            pending = self._replay(buf)
            cuda_align.add_launches(self.launches)
            self.replays += 1
        return pending

    def static_tensors(self) -> List[torch.Tensor]:
        """The tensors outside the graph pool that the replays read."""
        return [self.static_in]

    # the card's side of capture and replay

    def _warm_up(self) -> None:
        work, cap = streams(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(cap):
            self.static_in = torch.zeros(self.in_shape, dtype=torch.uint8,
                                         device=self.device)
            self.fn(self.static_in)

    def _capture_graph(self):
        work, cap = streams(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.stream(cap):
            graph.capture_begin(pool=pool_handle(self.device),
                                capture_error_mode="thread_local")
            try:
                out = self.fn(self.static_in)
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:
                    pass
                raise
            graph.capture_end()
        work.wait_stream(cap)
        return graph, out

    def _replay(self, buf: np.ndarray) -> Pending:
        work = work_stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(work):
            _stage_in(buf, self.static_in)
            self._graph.replay()
            return _stage_out(self.static_out, work)


def _into(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """Copy each result into its static tensor (same shape and dtype)."""
    for d, s in zip(dsts, srcs, strict=True):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"static {tuple(d.shape)} {d.dtype} takes no "
                             f"{tuple(s.shape)} {s.dtype}")
        d.copy_(s)


class FragChain:
    """One data row's frag-axis consensus call, captured: the row's
    shards' wire buffers (wire_encode_inputs' layout with S local slots
    each, shard k holding global slots k*S .. k*S + S - 1) in, the row's
    consensus out in consensus_votes_wire's assemble_out layout, as
    replays of each shard's phase-A and phase-B graphs
    (ops/consensus.py: frag_phase_a, frag_phase_b_next,
    frag_phase_b_last; consensus_votes_rounds_frag chains the same
    functions op by op) with the partials' copies and sum between them.

    One call, per round r: phase A on every shard (into its static
    partials); the other shards' partials copied to the first shard's
    card; the first shard's phase B, which sums the partials in shard
    order (sum_partials); then, in a middle round, the sums copied to
    the other shards and their phase B (each writes its next template
    into the static buffers its next phase A reads); the last round's
    phase B runs on the first shard only and packs the consensus."""

    def __init__(self, devices: Sequence, B: int, *, S: int, Pb: int,
                 Lt: int, min_column_support: int, scoring, rounds: int,
                 warm_frac: float, row: int = 0):
        self.devices = [torch.device(d) for d in devices]
        self.B, self.S, self.Pb, self.Lt = B, S, Pb, Lt
        self.min_column_support = min_column_support
        self.scoring = scoring
        self.rounds = max(1, rounds)
        self.warm_frac = warm_frac
        self.row = row
        self.in_shape = (B, cons_ops.wire_row_bytes(S, Pb, Lt))
        self.launches: List[Tuple[str, int]] = []
        self.capture_s = 0.0
        self.replays = 0                     # graph replays, all shards
        self.shard_replays = [0] * len(self.devices)
        self.n_graphs = 0
        self._plan: list = []

    # static state, allocated outside the graph pool before any capture

    def _alloc(self) -> None:
        devs, B, Lt = self.devices, self.B, self.Lt
        spec = cons_ops.partials_spec(B, Lt)

        def zeros(shape, dtype, dev):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def partials(dev):
            return cons_ops.VotePartials(*(zeros(sh, dt, dev)
                                           for sh, dt in spec))

        self.ins = [zeros(self.in_shape, torch.uint8, d) for d in devs]
        self.parts = [partials(d) for d in devs]
        # the first shard's copies of the others' partials (the partials
        # themselves where the shard shares its card)
        self.recv = [p if self._shares_first_card(k) else partials(devs[0])
                     for k, p in enumerate(self.parts)]
        # the sums, for the other shards' middle-round phase B
        if self.rounds > 1:
            total = partials(devs[0])
            self.totals = [total if self._shares_first_card(k)
                           else partials(d) for k, d in enumerate(devs)]
        else:
            self.totals = [None] * len(devs)
        # each shard's template of rounds 1 .. rounds-1 (round 0's is in
        # its wire buffer)
        self.tpls = [[None] + [zeros((B, Lt), torch.uint8, d)
                               for _ in range(1, self.rounds)] for d in devs]
        self.lens = [[None] + [zeros((B,), torch.int32, d)
                               for _ in range(1, self.rounds)] for d in devs]
        self.out = zeros((B, Lt // 4 + 4), torch.uint8, devs[0])

    def _shares_first_card(self, k: int) -> bool:
        return self.devices[k] == self.devices[0]

    def static_tensors(self) -> List[torch.Tensor]:
        """The tensors outside the graph pool that the replays read."""
        ts = [*self.ins, *(x for p in self.parts + self.recv + self.totals
                           if p is not None for x in p),
              *(t for per in self.tpls + self.lens for t in per[1:]),
              self.out]
        return list({id(t): t for t in ts}.values())

    # the pieces

    def _template(self, k: int, r: int):
        if r == 0:
            return cons_ops.wire_template(self.ins[k], S=self.S, Pb=self.Pb,
                                          Lt=self.Lt)
        return self.tpls[k][r], self.lens[k][r]

    def _phase_a(self, k: int, r: int) -> Callable[[], None]:
        Sw = cons_ops.frag_warm_slots(self.S * len(self.devices),
                                      self.warm_frac, r < self.rounds - 1)

        def fn():
            frags, fl, _, _, d0 = cons_ops.wire_split(
                self.ins[k], S=self.S, Pb=self.Pb, Lt=self.Lt)
            _into(self.parts[k], cons_ops.frag_phase_a(
                frags, fl, *self._template(k, r),
                d0 if self.scoring.band else None, S=self.S, k=k,
                warm_slots=Sw, scoring=self.scoring))
        return fn

    def _phase_b(self, k: int, r: int) -> Callable[[], None]:
        last = r == self.rounds - 1
        kw = dict(Lt=self.Lt, min_column_support=self.min_column_support)

        def fn():
            if k == 0:
                total = cons_ops.sum_partials(self.recv)
                if not last:
                    _into(self.totals[0], total)
            else:
                total = self.totals[k]
            tpl, tl = self._template(k, r)
            if last:
                _into([self.out], [cons_ops.frag_phase_b_last(
                    total, tpl, tl, **kw)])
            else:
                _into([self.tpls[k][r + 1], self.lens[k][r + 1]],
                      cons_ops.frag_phase_b_next(total, tpl, tl, **kw))
        return fn

    def _walk(self, piece, copy) -> None:
        """One call's steps in order: piece(k, fn) for shard k's graph of
        fn, copy(dsts, srcs) for a copy between static tensors."""
        nf = len(self.devices)
        for r in range(self.rounds):
            for k in range(nf):
                piece(k, self._phase_a(k, r))
            for k in range(1, nf):
                if self.recv[k] is not self.parts[k]:
                    copy(self.recv[k], self.parts[k])
            piece(0, self._phase_b(0, r))
            if r < self.rounds - 1:
                for k in range(1, nf):
                    if self.totals[k] is not self.totals[0]:
                        copy(self.totals[k], self.totals[0])
                    piece(k, self._phase_b(k, r))

    def capture(self) -> None:
        t0 = time.perf_counter()
        plan: list = []
        launches: List[Tuple[str, int]] = []

        def piece(k, fn):
            handle, rec = self._capture_piece(k, fn)
            plan.append((k, handle))
            launches.extend(rec)

        with _LOCK, self._enqueue():
            self._alloc()
            self._walk(piece, lambda dsts, srcs: plan.append((dsts, srcs)))
        self._plan, self.launches = plan, launches
        self.n_graphs = sum(isinstance(k, int) for k, _ in plan)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, bufs: Sequence[np.ndarray]) -> Pending:
        if len(bufs) != len(self.devices) or any(
                tuple(b.shape) != self.in_shape for b in bufs):
            raise ValueError(f"frag chain takes {len(self.devices)} x "
                             f"{self.in_shape}, got "
                             f"{[tuple(b.shape) for b in bufs]}")
        with _LOCK:
            with self._enqueue():
                for k, buf in enumerate(bufs):
                    self._stage_in(k, buf)
                for a, b in self._plan:
                    if isinstance(a, int):
                        self._replay_piece(a, b)
                        self.shard_replays[a] += 1
                    else:
                        for dst, src in zip(a, b):
                            dst.copy_(src, non_blocking=True)
                pending = self._stage_out()
            cuda_align.add_launches(self.launches)
            self.replays += self.n_graphs
        return pending

    # the card's side of capture and replay

    def _enqueue(self):
        return work_streams(self.devices)

    def _capture_piece(self, k: int, fn: Callable[[], None]):
        """fn run once eagerly (warm-up) and captured on shard k's card:
        (graph, its recorded launches)."""
        dev = self.devices[k]
        work, cap = streams(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(cap):
            cap.wait_stream(work)
            fn()
            with cuda_align.recording() as rec:
                graph.capture_begin(pool=pool_handle(dev),
                                    capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:
                        pass
                    raise
                graph.capture_end()
        work.wait_stream(cap)
        return graph, list(rec)

    def _replay_piece(self, k: int, graph) -> None:
        with torch.cuda.device(self.devices[k]):
            graph.replay()

    def _stage_in(self, k: int, buf: np.ndarray) -> None:
        with torch.cuda.device(self.devices[k]):
            _stage_in(buf, self.ins[k])

    def _stage_out(self) -> Pending:
        dev = self.devices[0]
        with torch.cuda.device(dev):
            return _stage_out(self.out, work_stream(dev))

def captured(key: tuple, fn: Callable[[torch.Tensor], torch.Tensor],
             in_shape: Sequence[int], device) -> CapturedCall:
    """The call captured for (device, key), captured now if this is the
    key's first use (thread-seconds under `graphs.capture`)."""
    full = (_index(device),) + tuple(key)
    with _LOCK:
        call = _calls.get(full)
        if call is None:
            call = CapturedCall(fn, in_shape, torch.device("cuda", full[0]))
            with STATS.timer("graphs.capture"):
                call.capture()
            _calls[full] = call
        return call


def frag_chain(key: tuple, devices: Sequence, B: int, *, row: int = 0,
               **kw) -> FragChain:
    """The frag chain captured for (data row, the row's devices, key),
    captured now if this is its first use (thread-seconds under
    `graphs.capture`)."""
    devs = [torch.device(d) for d in devices]
    full = ((_index(devs[0]), "frag", row)
            + tuple(_index(d) for d in devs) + tuple(key))
    with _LOCK:
        chain = _calls.get(full)
        if chain is None:
            chain = FragChain(devs, B, row=row, **kw)
            with STATS.timer("graphs.capture"):
                chain.capture()
            _calls[full] = chain
        return chain


def calls() -> dict:
    """Every captured call and frag chain, by (device index, key)."""
    with _LOCK:
        return dict(_calls)


def stats() -> dict:
    """Graphs captured and replayed by kind (the key's first item),
    capture seconds, the graph pools' bytes and the frag chains' static
    bytes by device, and graph replays by frag shard ("row,k")."""
    with _LOCK:
        by_kind: Dict[str, Dict[str, int]] = {}
        static: Dict[int, int] = {}
        shards: Dict[str, int] = {}
        for key, c in _calls.items():
            k = by_kind.setdefault(str(key[1]), dict(graphs=0, replays=0))
            k["graphs"] += c.n_graphs
            k["replays"] += c.replays
            if isinstance(c, FragChain):
                for t in c.static_tensors():
                    static[t.device.index] = (static.get(t.device.index, 0)
                                              + t.nbytes)
                for f, n in enumerate(c.shard_replays):
                    label = f"{c.row},{f}"
                    shards[label] = shards.get(label, 0) + n
        return dict(
            graphs=sum(c.n_graphs for c in _calls.values()),
            by_kind=by_kind,
            capture_s=sum(c.capture_s for c in _calls.values()),
            pool_bytes={idx: sum(n for _, n in pool_segments(idx))
                        for idx in _pools},
            static_bytes=static, frag_shard_replays=shards,
        )
