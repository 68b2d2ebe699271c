"""One run of one cell: set-up, the timed window, the score and the
check, and the result line.  run.py calls `run_cell` on the card; the
tests call it on the CPU at a small size."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from gpubench.gen import make_inputs
from gpubench.harness import check, trace
from gpubench.harness.job import CHUNK_READS, Job, PileTap
from gpubench.harness.spec import ROOT, Cell
from gpubench.harness.window import Window, drive

KERNELS = ("banded_posterior", "full_posterior")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def fasta_path(cell: str) -> str:
    """Where each pass writes its FASTA: under TMPDIR, or inside the
    checkout when none is set; a fixed name, overwritten by every pass."""
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, ".gpubench_out")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"gpubench-{cell}.fasta")


def cpu_seconds() -> float:
    """This process's CPU seconds so far: over the window, set against
    its length, they show how many cores the run kept busy, and between
    runs of the same inputs, how much dearer the host made the same
    work."""
    t = os.times()
    return t.user + t.system


@dataclasses.dataclass
class PassLog:
    pulled: List[str]
    yielded: List[str] = dataclasses.field(default_factory=list)
    ended: bool = False


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str, setup_clock: Callable[[], float],
             control: Optional[str] = None,
             run_pass_hook: Optional[Callable] = None):
    """(result line, checks).  setup_clock() is the seconds since the
    process started.  run_pass_hook(job, job.run_pass) may return a
    wrapped timed path (tests plant faults with it)."""
    import torch

    t0 = time.perf_counter()
    inputs = make_inputs(cell.config["job"], cell.traffic, seed)
    log(f"inputs: {len(inputs.reads)} reads, "
        f"{sum(len(c) for _, c in inputs.queries())} query bases "
        f"({time.perf_counter() - t0:.3f} s)")
    t1 = time.perf_counter()
    job = Job(cell.config, inputs, fasta_path(cell.name), device)
    job.set_up(np.random.default_rng([seed, 3]))
    log(f"set-up of the program {time.perf_counter() - t1:.3f} s")

    from consent_tpu_torch.utils.observe import GLOBAL_STATS

    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()

    window = Window(seconds, CHUNK_READS, cell.traffic.get("close", "pass"))
    outputs: Dict[str, tuple] = {}
    piles: Dict[str, object] = {}
    passes: List[PassLog] = []
    taps: List[PileTap] = []
    spans = trace.Spans() if traced else None
    closed: dict = {}

    timed_path = job.run_pass
    if run_pass_hook is not None:
        timed_path = run_pass_hook(job, timed_path)

    def run_pass():
        def tapped(stream):
            tap = PileTap(stream, time.perf_counter, spans)
            taps.append(tap)
            passes.append(PassLog(tap.names))
            return tap

        inner = timed_path(tapped)

        def gen():
            try:
                for item in inner:
                    passes[-1].yielded.append(item[0])
                    yield item
                passes[-1].ended = True
                st = GLOBAL_STATS.snapshot()["seconds"]
                log(f"pass {len(passes)} ended at "
                    f"{time.perf_counter() - window.t0:.3f} s; stage "
                    f"thread-seconds so far: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in sorted(st.items())))
            finally:
                inner.close()

        return gen()

    def on_output(item):
        name, codes, solid = item
        outputs[name] = (codes, solid)

    def on_close():
        job.aligner.counting = False
        closed["stats"] = GLOBAL_STATS.snapshot()
        closed["cpu"] = cpu_seconds()
        closed["wait_s"] = sum(t.wait_s for t in taps)
        closed["pulled"] = sum(len(t.names) for t in taps)
        closed["captured"] = graph_ops.stats()["graphs"] - graphs_before
        if device != "cpu":
            closed["peak"] = torch.cuda.max_memory_allocated()

    from consent_tpu_torch.ops import graphs as graph_ops

    graphs_before = graph_ops.stats()["graphs"]
    prof = trace.Profile() if traced else None
    setup_s = setup_clock()
    cpu0 = cpu_seconds()
    job.aligner.counting = True
    if traced:
        with prof, trace.stage_spans(GLOBAL_STATS, spans):
            prof.mark()
            drive(window, run_pass, lambda it: job.query_len[it[0]],
                  on_output, on_close)
    else:
        drive(window, run_pass, lambda it: job.query_len[it[0]], on_output,
              on_close)
    t_done = time.perf_counter()
    log(f"window {window.seconds_measured:.3f} s: {window.outputs} outputs, "
        f"chunks ended at {[round(b, 3) for b in window.chunks]} s, "
        f"passes at {[round(b, 3) for b in window.pass_ends]} s, "
        f"{window.bases} bases; closing took {t_done - window.t_close:.3f} s")
    log("stage thread-seconds at the close: " + ", ".join(
        f"{k} {v:.3f} ({closed['stats']['counts'].get(k, 0)})"
        for k, v in sorted(closed["stats"]["seconds"].items()))
        + f"; overlap wait {closed['wait_s']:.3f} s over "
        f"{closed['pulled']} piles; {closed['captured']} graphs captured "
        f"in the window")
    cpu_s = closed["cpu"] - cpu0
    log(f"process CPU seconds in the window: {cpu_s:.3f} "
        f"({cpu_s / window.seconds_measured:.3f} cores on average)")
    for t in taps:
        piles.update(t.piles)

    m = dict(cell=cell.name, job=cell.config["job"], setup_s=setup_s,
             window_s=window.seconds_measured, bases=window.bases,
             outputs=window.outputs, passes=window.passes,
             stats_seconds=closed["stats"]["seconds"],
             stats_counts=closed["stats"]["counts"],
             overlap_wait_s=closed["wait_s"], piles_pulled=closed["pulled"],
             stitch_card=dict(lanes=job.aligner.lanes,
                              cells=job.aligner.cells, ops=job.aligner.ops,
                              bytes=job.aligner.nbytes),
             trace=None)
    reduced = None
    if traced:
        t2 = time.perf_counter()
        reduced = trace.reduce(prof.device_events(), window.t0,
                               window.t_close, spans.items, KERNELS)
        m["trace"] = reduced
        log(f"trace: {reduced['device_events']} device events, busy "
            f"{reduced['busy_s']:.6f} s of {reduced['window_s']:.6f} s, "
            f"kernels {reduced['kernel_s']} "
            f"({time.perf_counter() - t2:.3f} s to reduce)")

    t3 = time.perf_counter()
    k = int(cell.traffic.get("check", {}).get("error_sample", 512))
    m["error_pct"], m["error_n"] = check.error_pct(outputs, inputs, k, seed,
                                                   device)
    log(f"error {m['error_pct']:.6f} % over {m['error_n']} outputs "
        f"({time.perf_counter() - t3:.3f} s)")
    t4 = time.perf_counter()
    checks = check.compare(cell, inputs, job.cfg, outputs, piles,
                           [(p.pulled, p.yielded, p.ended) for p in passes],
                           job.aligner.samples, seed, device, control)
    log(f"reference check {time.perf_counter() - t4:.3f} s over "
        f"{len(job.aligner.samples)} stitch lanes and the sampled outputs")

    metrics = {}
    for metric in (cell.per_layer if traced else cell.end_to_end):
        v = metric.read(m)
        if v is not None:
            metrics[metric.name] = {"value": v, "unit": metric.unit}
    dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    if device != "cpu":
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=cell.chips, memory_peak_bytes=closed["peak"])
    if traced:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    ok = check.passed(checks)
    result = {"correct": ok, "attempted": window.outputs,
              "failed": sum(c["value"] for c in checks.values()),
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    return result, checks
