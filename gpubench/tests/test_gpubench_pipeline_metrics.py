"""The readers of the program's pipeline spans (metrics/pipeline.*,
overlap.first_pile_s, host_post.*, geometry.on_cpu_pct): a number from
a hand-made run's measures, None where the program has no such stage
(as a program without these spans has none), and a number from each
over a small pass of the cell's job on the CPU."""

import time

import numpy as np
import pytest

from gpubench.harness import spec
from gpubench.tests.helpers import tiny_cell

READERS = {
    "pipeline.pull_pct": ("pipeline.pull", 12.5),
    "pipeline.wait_consensus_pct": ("pipeline.wait_consensus", 25.0),
    "pipeline.stitch_pct": ("pipeline.stitch", 50.0),
    "overlap.first_pile_s": ("overlap.first_pile", 3.0),
    "host_post.queue_s_per_kwin": ("host_post.queue", 0.5),
    "host_post.native_s_per_kwin": ("host_post.native", 1.5),
    "host_post.on_cpu_pct": ("host_post.run.cpu", 75.0),
    "geometry.on_cpu_pct": ("geometry.run.cpu", 40.0),
}


def measures():
    """A window of 40 s with 2 passes and 2,000 windows post-processed."""
    seconds = {"pipeline.pull": 5.0, "pipeline.wait_consensus": 10.0,
               "pipeline.stitch": 20.0, "overlap.first_pile": 6.0,
               "host_post.queue": 1.0, "host_post.native": 3.0,
               "host_post.run": 8.0, "host_post.run.cpu": 6.0,
               "geometry.run": 5.0, "geometry.run.cpu": 2.0,
               "consensus.kmer_dbg": 9.0}
    counts = {k: 1 for k in seconds}
    counts.update({"overlap.first_pile": 2, "consensus.kmer_dbg": 2000})
    return dict(window_s=40.0, stats_seconds=seconds, stats_counts=counts)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_a_hand_made_run(name):
    stage, want = READERS[name]
    read = spec.reader(name)
    assert read(measures()) == pytest.approx(want)
    m = measures()
    del m["stats_seconds"][stage], m["stats_counts"][stage]
    assert read(m) is None


def test_readers_read_a_pass_on_the_cpu():
    """One pass of the cell's job (the CLI's overlapper into
    process_piles) at the tiny size; m built from GLOBAL_STATS as
    harness/runner.py builds it."""
    from consent_tpu_torch.utils.observe import GLOBAL_STATS
    from gpubench.gen import make_inputs
    from gpubench.harness.job import Job
    from gpubench.harness.runner import fasta_path

    cell = tiny_cell()
    inputs = make_inputs(cell.config["job"], cell.traffic, 11)
    job = Job(cell.config, inputs, fasta_path(cell.name), "cpu")
    job.set_up(np.random.default_rng(11))
    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()
    t0 = time.perf_counter()
    n = sum(1 for _ in job.run_pass(lambda stream: stream))
    window_s = time.perf_counter() - t0
    snap = GLOBAL_STATS.snapshot()
    m = dict(window_s=window_s, stats_seconds=snap["seconds"],
             stats_counts=snap["counts"])
    assert n == len(inputs.queries())
    for name in READERS:
        v = spec.reader(name)(m)
        assert v is not None and v >= 0, name
        assert not name.endswith("_pct") or v <= 100, name
    parts = sum(snap["seconds"][k] for k in (
        "pipeline.pull", "pipeline.wait_geometry", "pipeline.wait_consensus",
        "pipeline.stitch", "pipeline.consumer"))
    assert parts <= window_s
