"""The cost of one span of the port's stage recorder
(consent_tpu_torch/utils/observe.py), on this host's CPU.

    python3 probes/span_cost.py [--n 200000]

Times `timer`, `cpu_timer`, a call through `task` and `add_seconds`,
each over n empty bodies, on one thread and on four threads at once
(the pipeline's pools contend for the GIL and the recorder's lock), and
prints one JSON line of microseconds per span.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from consent_tpu_torch.utils.observe import StageStats  # noqa: E402


def kinds(stats: StageStats):
    def timer():
        with stats.timer("probe.timer"):
            pass

    def cpu_timer():
        with stats.cpu_timer("probe.cpu_timer"):
            pass

    task = stats.task("probe.task", lambda: None)

    def add():
        stats.add_seconds("probe.add", 0.0)

    def bare():
        pass

    return dict(bare=bare, timer=timer, cpu_timer=cpu_timer, task=task,
                add_seconds=add)


def per_span_us(fn, n: int, threads: int) -> float:
    """Wall microseconds per call, n calls on each of `threads` threads,
    over all calls made."""
    def loop():
        for _ in range(n):
            fn()

    ts = [threading.Thread(target=loop) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return 1e6 * (time.perf_counter() - t0) / (n * threads)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=200000)
    args = p.parse_args()
    stats = StageStats()
    out = {}
    for threads in (1, 4):
        for name, fn in kinds(stats).items():
            per_span_us(fn, args.n // 10, threads)     # warm
            out[f"{name}_us_t{threads}"] = round(
                per_span_us(fn, args.n, threads), 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
