"""Structured per-stage observability.

Every pipeline stage reports counts and wall time through one registry;
stderr only — stdout stays a pure data channel.

Every number is an entry of `StageStats.seconds` (by stage) with its
count in `StageStats.counts`, on one clock, `time.perf_counter`; a
thread's CPU seconds over a stage (`time.thread_time`) are the stage
`<stage>.cpu`.  Every span goes through `StageStats.timer`, so a caller
that replaces `timer` on the instance sees them all.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator


class StageStats:
    """Thread-safe accumulation of per-stage counters and timings."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # set by profiler_trace: each span is also a record_function range
        self.profiling = False

    @contextlib.contextmanager
    def timer(self, stage: str, n: int = 1) -> Iterator[None]:
        with _profiler_range(stage) if self.profiling else _NO_RANGE:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add_seconds(stage, time.perf_counter() - t0, n)

    @contextlib.contextmanager
    def cpu_timer(self, stage: str, n: int = 1) -> Iterator[None]:
        """`timer(stage, n)`, and the calling thread's CPU seconds inside
        it as the stage `<stage>.cpu`: wall minus CPU is the time the
        thread waited (for the GIL, a lock, a core)."""
        with self.timer(stage, n):
            c0 = time.thread_time()
            try:
                yield
            finally:
                self.add_seconds(stage + ".cpu", time.thread_time() - c0, n)

    def task(self, stage: str, fn: Callable) -> Callable:
        """fn wrapped for a pool, at submit time.  Each call records
        `<stage>.queue` (from the wrapping to the call's start),
        `<stage>.run` and `<stage>.run.cpu` (its wall and its thread's
        CPU seconds).  A caller that runs the task itself records a
        queue of ~0."""
        submitted = time.perf_counter()

        def run(*args, **kwargs):
            self.add_seconds(stage + ".queue",
                             time.perf_counter() - submitted)
            with self.cpu_timer(stage + ".run"):
                return fn(*args, **kwargs)

        return run

    def add_seconds(self, stage: str, seconds: float, n: int = 1) -> None:
        """Seconds summed by the caller (over several intervals) and
        their count, added to `stage`."""
        with self._lock:
            self.seconds[stage] += seconds
            self.counts[stage] += n

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counts[counter] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seconds": dict(self.seconds),
                "counts": dict(self.counts),
            }

    def report(self, file=sys.stderr) -> None:
        snap = self.snapshot()
        lines = {}
        for stage, secs in sorted(snap["seconds"].items()):
            n = snap["counts"].get(stage, 0)
            rate = n / secs if secs > 0 else 0.0
            lines[stage] = {
                "seconds": round(secs, 3),
                "count": n,
                "per_s": round(rate, 1),
            }
        for counter, n in sorted(snap["counts"].items()):
            if counter not in lines:
                lines[counter] = {"count": n}
        print(json.dumps({"consent_tpu_stats": lines}), file=file)


GLOBAL_STATS = StageStats()

_NO_RANGE = contextlib.nullcontext()


def _profiler_range(stage: str):
    from torch.profiler import record_function

    return record_function(stage)


@contextlib.contextmanager
def profiler_trace(logdir: str | None,
                   stats: StageStats = GLOBAL_STATS) -> Iterator[None]:
    """torch.profiler trace context (no-op when logdir is None): host
    ops, `stats`' spans as record_function ranges on the thread that
    ran each, and the card's kernels and copies when there is a card,
    written as a Chrome trace to <logdir>/trace-<pid>.json."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    try:
        # the pools' threads too (a torch without the option records
        # the calling thread's ranges only)
        from torch._C._profiler import _ExperimentalConfig

        extra = dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except (ImportError, TypeError):
        extra = {}
    with profile(activities=activities, **extra) as prof:
        stats.profiling = True
        try:
            yield
        finally:
            stats.profiling = False
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))
