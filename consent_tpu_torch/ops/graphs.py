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
Two shards on one card share that call, and that is safe: each replay
and the copy of its output to the host are enqueued together, under the
lock, on the card's one work stream, so the second replay overwrites
the static output only after the first one's copy has read it.

On the CPU nothing is captured: the callers run their plain path.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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


def calls() -> Dict[tuple, CapturedCall]:
    """Every captured call, by (device index, key)."""
    with _LOCK:
        return dict(_calls)


def stats() -> dict:
    """Captured calls and their replays by kind (the key's first item),
    capture seconds, and the graph pools' bytes by device."""
    with _LOCK:
        by_kind: Dict[str, Dict[str, int]] = {}
        for key, c in _calls.items():
            k = by_kind.setdefault(str(key[1]), dict(graphs=0, replays=0))
            k["graphs"] += 1
            k["replays"] += c.replays
        return dict(
            graphs=len(_calls), by_kind=by_kind,
            capture_s=sum(c.capture_s for c in _calls.values()),
            pool_bytes={idx: sum(n for _, n in pool_segments(idx))
                        for idx in _pools},
        )
