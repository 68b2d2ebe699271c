"""Structured per-stage observability.

Every pipeline stage reports counts and wall time through one registry;
stderr only — stdout stays a pure data channel.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageStats:
    """Thread-safe accumulation of per-stage counters and timings."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, stage: str, n: int = 1) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[stage] += dt
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


@contextlib.contextmanager
def profiler_trace(logdir: str | None) -> Iterator[None]:
    """Profiler trace context: a no-op without a log directory.
    Tracing through torch.profiler is not ported yet."""
    if logdir:
        raise NotImplementedError(
            "--profile-dir is not supported by consent_tpu_torch yet"
        )
    yield
