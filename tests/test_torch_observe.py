"""The port's stage recorder (utils/observe.py) and the spans and
counters of the three-slot pipeline, on the CPU.

One small `process_piles` run, in chunks of two piles so that every
slot of the pipeline holds a chunk, with `GLOBAL_STATS.timer` replaced
by a wrapper of the benchmark harness's signature (`timer(stage, n=1)`,
calling the original positionally), as a traced benchmark run replaces
it."""

import contextlib
import glob
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from consent_tpu_torch import native
from consent_tpu_torch.config import correct_preset
from consent_tpu_torch.core import windows
from consent_tpu_torch.io.fasta import ReadIndex
from consent_tpu_torch.ops import graphs as graph_ops
from consent_tpu_torch.pipeline import engine as t_engine
from consent_tpu_torch.testing import simulate
from consent_tpu_torch.utils import hostpool, observe
from consent_tpu_torch.utils.observe import GLOBAL_STATS, StageStats

torch.set_num_threads(2)

PIPELINE = ("pipeline.pull", "pipeline.wait_geometry",
            "pipeline.wait_consensus", "pipeline.stitch", "pipeline.consumer")
TASKS = ("geometry", "consensus.chain", "host_post")
CONSUMER_SLEEP = 0.005      # the test's own time per output


@contextlib.contextmanager
def harness_wrapper(stats, seen):
    """The benchmark's traced-run wrapper, reduced to what it relies on:
    same signature, the original called with (stage, n)."""
    orig = stats.timer

    @contextlib.contextmanager
    def timer(stage, n=1):
        with orig(stage, n):
            yield
        with lock:
            seen.append(stage)

    lock = threading.Lock()
    stats.timer = timer
    try:
        yield
    finally:
        del stats.timer


@pytest.fixture(scope="module")
def run():
    genome, reads = simulate.simulate(genome_len=3000, coverage=14.0,
                                      read_len=900, error_rate=0.10, seed=42)
    cfg = correct_preset(window_size=200, window_overlap=20, min_support=3,
                         n_workers=2)
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    piles = simulate.piles_from_sim(reads, cfg.max_support)[:6]
    before = {n: index[n].copy() for n in index.names()}
    calls = {k: 0 for k in TASKS + ("host_post_batch",)}
    threads = {}
    lock = threading.Lock()

    def counting(key, fn):
        def wrapped(*a, **k):
            with lock:
                calls[key] += 1
                threads.setdefault(key, set()).add(threading.current_thread())
            return fn(*a, **k)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(t_engine, "windows_of_piles",
               counting("geometry", t_engine.windows_of_piles))
    mp.setattr(t_engine.ConsensusEngine, "_job_chain",
               counting("consensus.chain",
                        t_engine.ConsensusEngine._job_chain))
    mp.setattr(native, "host_post_batch_native",
               counting("host_post_batch", native.host_post_batch_native))
    seen = []
    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()
    try:
        with harness_wrapper(GLOBAL_STATS, seen):
            t0 = time.perf_counter()
            outs = []
            for item in t_engine.process_piles(iter(piles), index, cfg,
                                               chunk_reads=2, device="cpu"):
                time.sleep(CONSUMER_SLEEP)
                outs.append(item)
            wall = time.perf_counter() - t0
        snap = GLOBAL_STATS.snapshot()
    finally:
        mp.undo()
        GLOBAL_STATS.seconds.clear()
        GLOBAL_STATS.counts.clear()
    calls["host_post"] = calls.pop("host_post_batch")
    index_unchanged = all(np.array_equal(index[n], a)
                          for n, a in before.items())
    return dict(snap=snap, wall=wall, calls=calls, seen=seen, outs=outs,
                n_piles=len(piles), piles=piles, index=index, cfg=cfg,
                threads=threads, index_unchanged=index_unchanged)


def test_pipeline_stages_add_up_to_the_wall(run):
    s, c = run["snap"]["seconds"], run["snap"]["counts"]
    assert len(run["outs"]) == run["n_piles"]
    total = sum(s[k] for k in PIPELINE)
    assert abs(total - run["wall"]) <= max(0.05 * run["wall"], 0.05), (
        {k: s[k] for k in PIPELINE}, run["wall"])
    assert c["overlap.first_pile"] == 1
    assert s["overlap.first_pile"] <= s["pipeline.pull"]
    # 3 chunks and the pull that ends the stream; a wait on each slot a
    # chunk; the consumer's own sleeps are inside its stage
    assert c["pipeline.pull"] == 4
    assert c["pipeline.wait_geometry"] == c["pipeline.wait_consensus"] == 3
    assert c["pipeline.stitch"] == c["pipeline.consumer"] == run["n_piles"]
    assert s["pipeline.consumer"] >= run["n_piles"] * CONSUMER_SLEEP


@pytest.mark.parametrize("stage", TASKS)
def test_pool_tasks_record_queue_run_and_cpu(run, stage):
    s, c = run["snap"]["seconds"], run["snap"]["counts"]
    n = run["calls"][stage]
    assert n > 0
    for part in (".queue", ".run", ".run.cpu"):
        assert c[stage + part] == n, part
    assert s[stage + ".queue"] >= 0.0
    # one thread's CPU time inside an interval is at most its wall
    assert s[stage + ".run.cpu"] <= s[stage + ".run"] + 1e-6 * n


def test_geometry_counters_match_the_per_window_oracle(run):
    """geometry.pairs counts the (window, overlap) pairs whose query
    spans intersect, geometry.frags the support fragments kept, both
    as clip_fragments called window by window gives them."""
    c, cfg = run["snap"]["counts"], run["cfg"]
    pairs = frags = 0
    for pile in run["piles"]:
        seq_map = windows.sequences_map(pile, run["index"])
        q_len = len(seq_map[pile.q_name])
        pos = windows.window_positions(
            q_len, windows.coverage(q_len, pile.ov), cfg.min_support,
            cfg.window_size, cfg.window_overlap)
        ov = pile.ov
        for b, e in pos:
            pairs += int(((ov["q_start"] <= e) & (ov["q_end"] >= b)).sum())
            frags += len(windows.clip_fragments(pile, seq_map, b, e,
                                                cfg.mer_size)) - 1
    assert frags > 0 and pairs > frags
    assert c["geometry.pairs"] == pairs
    assert c["geometry.frags"] == frags


def test_stitch_counts_its_native_rounds(run):
    """Every chunk's stitch is a native table: each stitched window is
    applied by its native apply (no round of 8 lanes or fewer went to
    the host aligner, which the CPU path leaves out), in group rounds
    that each made one apply."""
    c = run["snap"]["counts"]
    assert c["stitch.windows_native"] == c["windows.total"] > 0
    assert c.get("stitch.host_lanes", 0) == 0
    assert 0 < c["stitch.rounds_native"] <= c["stitch.apply"]
    assert c["stitch.apply"] == c["stitch.windows_native"]


def test_geometry_runs_on_its_slot_thread_once_a_chunk(run):
    """Every chunk is one geometry task, called on the geometry slot's
    own thread: none on the caller's thread or on a shared pool's."""
    c = run["snap"]["counts"]
    assert run["calls"]["geometry"] == 3      # chunks of two piles
    for part in (".queue", ".run", ".run.cpu"):
        assert c["geometry" + part] == 3, part
    (geo,) = run["threads"]["geometry"]
    assert geo is not threading.main_thread()
    pooled = {t for pool in hostpool._POOLS.values() for t in pool._threads}
    # the host post's slices fan out over the shared `work` pool
    assert run["threads"]["host_post_batch"] <= pooled
    assert run["threads"]["host_post_batch"]
    assert geo not in pooled


def test_geometry_stays_off_the_pool_for_a_full_chunk(monkeypatch):
    """A chunk of eight piles, enough to fan out over a pool, is one
    geometry task on the slot's own thread."""
    genome, reads = simulate.simulate(genome_len=3000, coverage=14.0,
                                      read_len=900, error_rate=0.10, seed=42)
    cfg = correct_preset(window_size=200, window_overlap=20, min_support=3,
                         n_workers=2)
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    piles = simulate.piles_from_sim(reads, cfg.max_support)[:8]
    seen = []
    orig = t_engine.windows_of_piles

    def wrapped(*a, **k):
        seen.append(threading.current_thread())
        return orig(*a, **k)

    monkeypatch.setattr(t_engine, "windows_of_piles", wrapped)
    stats = StageStats()
    monkeypatch.setattr(t_engine, "STATS", stats)
    outs = list(t_engine.process_piles(iter(piles), index, cfg,
                                       chunk_reads=8, device="cpu"))
    assert len(outs) == 8 and len(seen) == 1
    pooled = {t for pool in hostpool._POOLS.values() for t in pool._threads}
    assert pooled and not set(seen) & pooled
    assert seen[0] is not threading.main_thread()
    assert stats.counts["geometry.run"] == 1


def test_fragment_views_leave_the_read_index_unchanged(run):
    """Fragments are views of the index's arrays (or of a geometry
    pass's reverse complements): a whole run writes none of them."""
    assert run["index_unchanged"]


def test_host_post_native_and_marshal_lie_inside_its_tasks(run):
    s, c = run["snap"]["seconds"], run["snap"]["counts"]
    n = run["calls"]["host_post"]
    assert c["host_post.native"] == c["host_post.marshal"] == n
    assert c["host_post.native.cpu"] == c["host_post.marshal.cpu"] == n
    assert s["host_post.native"] + s["host_post.marshal"] <= s[
        "host_post.run"]
    assert s["host_post.native.cpu"] <= s["host_post.native"] + 1e-6 * n
    # kept templates are among the windows post-processed; no slice
    # failed its capacity check here
    assert c.get("host_post.template_kept", 0) <= c["consensus.kmer_dbg"]
    assert c.get("host_post.fallback", 0) == 0


def test_new_spans_go_through_the_replaced_timer(run):
    seen = set(run["seen"])
    for stage in PIPELINE[:-1] + ("overlap.first_pile", "host_post.native",
                                  "host_post.marshal", "geometry.run",
                                  "consensus.chain.run", "host_post.run",
                                  "windows.geometry", "stitch.total",
                                  "consensus.kmer_dbg"):
        assert stage in seen, stage
    # sums the caller adds are not spans
    assert "pipeline.consumer" not in seen
    assert not any(st.endswith((".cpu", ".queue")) for st in seen)


def test_recorder_under_a_replaced_timer():
    stats, seen = StageStats(), []
    with harness_wrapper(stats, seen):
        with stats.timer("a", 3):
            pass
        with stats.cpu_timer("b"):
            sum(range(10000))
        with ThreadPoolExecutor(2) as pool:
            task = stats.task("c", lambda x: x + 1)
            assert list(pool.map(task, range(5))) == [1, 2, 3, 4, 5]
        stats.add_seconds("d", 0.25, 4)
    assert sorted(seen) == ["a", "b"] + ["c.run"] * 5
    assert "timer" not in vars(stats)
    c, s = stats.counts, stats.seconds
    assert (c["a"], c["b"], c["b.cpu"], c["d"]) == (3, 1, 1, 4)
    assert c["c.queue"] == c["c.run"] == c["c.run.cpu"] == 5
    assert s["d"] == 0.25
    assert s["b.cpu"] <= s["b"] + 1e-6


def test_record_function_ranges_only_inside_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    stats = StageStats()

    def spans(tag):
        with stats.timer(f"{tag}.main"):
            pass
        with ThreadPoolExecutor(1) as pool:
            pool.submit(stats.task(f"{tag}.pooled", lambda: None)).result()

    # a profiler that profiler_trace did not start sees no range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans("outside")
    assert not any(e.name.startswith("outside.")
                   for e in prof.events())
    with observe.profiler_trace(str(tmp_path), stats):
        assert stats.profiling
        spans("inside")
    assert not stats.profiling
    spans("after")
    (path,) = glob.glob(str(tmp_path / "trace-*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "inside.main" in names
    assert not any(n and n.startswith(("outside.", "after."))
                   for n in names)


class _NoCapture(graph_ops.CapturedCall):
    """A captured call whose capture does nothing: the test counts the
    captures, not what they hold."""

    def capture(self):
        pass


def test_graphs_capture_counts_every_capture(monkeypatch):
    cfg = correct_preset(window_size=200, window_overlap=20, min_support=3)
    eng = t_engine.ConsensusEngine(cfg, device="cpu")
    monkeypatch.setattr(graph_ops, "_calls", {})
    monkeypatch.setattr(graph_ops, "_pools", {})
    monkeypatch.setattr(graph_ops, "_index", lambda device: 0)
    monkeypatch.setattr(graph_ops, "CapturedCall", _NoCapture)
    stats = StageStats()
    monkeypatch.setattr(graph_ops, "STATS", stats)
    monkeypatch.setattr(t_engine, "STATS", stats)
    eng._capture_all()
    n = len(eng.call_shapes())
    assert n > 0 and stats.counts["graphs.capture"] == n
    assert "consensus.capture" not in stats.counts
    eng._capture_all()          # every shape found: nothing captured
    assert stats.counts["graphs.capture"] == n


def test_host_post_counts_fallback_and_kept_templates(monkeypatch):
    """A batch call that fails its capacity check sends its slice down
    the per-window path; windows under the anchor gate keep their
    template, counted in both paths alike."""
    rng = np.random.default_rng(3)
    cfg = correct_preset(window_size=200, window_overlap=20, min_support=3,
                         n_workers=1)
    eng = t_engine.ConsensusEngine(cfg, device="cpu")
    tpl = rng.integers(0, 4, 200, dtype=np.uint8)
    good = [np.array(tpl) for _ in range(6)]
    noise = [rng.integers(0, 4, 200, dtype=np.uint8) for _ in range(6)]

    def tasks():
        return [t_engine.WindowTask(0, i, (0, 200), list(f))
                for i, f in enumerate([good, noise, good, noise])]

    cons = [tpl] * 4
    counts = {}
    for fail in (False, True):
        stats = StageStats()
        monkeypatch.setattr(t_engine, "STATS", stats)
        if fail:
            monkeypatch.setattr(native, "host_post_batch_native",
                                lambda *a, **k: None)
        ts = tasks()
        eng._host_post(ts, 8, cons)
        counts[fail] = (stats.counts.get("host_post.fallback", 0),
                        stats.counts["host_post.template_kept"],
                        [t.consensus.tobytes() for t in ts])
    assert counts[False][0] == 0 and counts[True][0] == 4
    assert counts[False][1] == counts[True][1] == 2
    assert counts[False][2] == counts[True][2]
