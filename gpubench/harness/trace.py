"""The traced run: host spans and the card's activity, reduced in memory.

Host spans come from the harness: its own wait on the pile stream
(`overlap_wait`), and the program's stage timers (`GLOBAL_STATS.timer`,
utils/observe.py), which a traced run wraps so that each timed stage
also leaves an interval.  The card's activity (kernels, copies, sets)
comes from torch.profiler's raw events; a marker recorded at the
window's start puts both on the host's clock.  Nothing is written to
disk.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ANCHOR = "gpubench.window_start"

# the program's stage timers, by the layer they belong to
STAGE_LABELS = {
    "windows.geometry": "geometry",
    "consensus.build_batch": "consensus",
    "consensus.dispatch": "consensus",
    "consensus.device_votes": "consensus",
    "consensus.kmer_dbg": "host_post",
    "stitch.total": "stitch",
}


class Spans:
    """Host intervals by label, on time.perf_counter's clock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.items: List[Tuple[str, float, float]] = []

    def add(self, label: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((label, t0, t1))


@contextlib.contextmanager
def stage_spans(stats, spans: Spans):
    """Wrap the program's StageStats.timer so that every labelled stage
    also records its interval; restored on exit."""
    orig = stats.timer

    @contextlib.contextmanager
    def timer(stage, n=1):
        t0 = time.perf_counter()
        try:
            with orig(stage, n):
                yield
        finally:
            label = STAGE_LABELS.get(stage)
            if label is not None:
                spans.add(label, t0, time.perf_counter())

    stats.timer = timer
    try:
        yield
    finally:
        del stats.timer


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _covered(merged: Sequence[Sequence[float]], lo: float, hi: float
             ) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def reduce(device_events: Sequence[Tuple[str, float, float]],
           t0: float, t1: float, spans: Sequence[Tuple[str, float, float]],
           kernels: Sequence[str], top: int = 10) -> dict:
    """The card's busy seconds in [t0, t1], device seconds by kernel
    name, the device operations that took most time, and the longest
    idle gaps, each named by the host span that covers most of it.
    device_events are (name, start, end) on the host's clock."""
    evs = [(n, a, b) for n, a, b in device_events if b > t0 and a < t1]
    busy = union(_clip([(a, b) for _, a, b in evs], t0, t1))
    busy_s = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for n, a, b in evs:
        by_name[n] = by_name.get(n, 0.0) + (min(b, t1) - max(a, t0))
    kernel_s = {}
    for k in kernels:
        pat = re.compile(rf"\b{k}(_\w+)?_kernel")
        kernel_s[k] = sum(s for n, s in by_name.items() if pat.search(n))
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1 > prev:
        gaps.append((prev, t1))
    by_label: Dict[str, List[List[float]]] = {}
    for label, a, b in spans:
        by_label.setdefault(label, []).append((a, b))
    by_label = {k: union(v) for k, v in by_label.items()}
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        cover = {k: _covered(v, a, b) for k, v in by_label.items()}
        label = max(cover, key=cover.get) if cover else "none"
        if not cover or cover[label] <= 0:
            label = "none"
        named.append([f"{label} at {a - t0:.3f} s", b - a])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy_s, window_s=t1 - t0, kernel_s=kernel_s,
                device_ops=[[n[:120], s] for n, s in ops], idle_gaps=named,
                device_events=len(evs))


class Profile:
    """torch.profiler over the window, with the anchor marker."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.anchor_perf: Optional[float] = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def mark(self) -> float:
        """Record the anchor; returns its time on the host's clock."""
        from torch.profiler import record_function

        self.anchor_perf = time.perf_counter()
        with record_function(ANCHOR):
            pass
        return self.anchor_perf

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def device_events(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every CUDA activity, on the host's
        clock."""
        events = self.prof.profiler.kineto_results.events()
        anchor = None
        out = []
        for e in events:
            dev = str(e.device_type())
            if e.name() == ANCHOR and anchor is None:
                anchor = e.start_ns()
            elif dev.endswith("CUDA"):
                out.append((e.name(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
        if anchor is None:
            raise RuntimeError("the profiler lost the window's marker")
        t = self.anchor_perf
        return [(n, t + (a - anchor) * 1e-9, t + (b - anchor) * 1e-9)
                for n, a, b in out]
