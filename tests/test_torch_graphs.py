"""The captured device calls' host side, on the CPU: the call shapes the
engine captures up front are exactly those it dispatches, a captured
call's replays count the launches its capture recorded, and the vote
epilogue's int32 leading-run count equals the JAX package's cumprod
count.  The captures and replays themselves run on the card only
(chip_smoke.py: graph phase)."""

import threading

import numpy as np
import pytest
import torch

from consent_tpu_torch.config import correct_preset
from consent_tpu_torch.ops import consensus as cons_ops
from consent_tpu_torch.ops import cuda_align
from consent_tpu_torch.ops import graphs as graph_ops
from consent_tpu_torch.pipeline import engine as eng_mod

torch.set_num_threads(2)


def _tasks_filling_every_bucket(eng, rng):
    """For each fragment count 1 .. max_msa + 1 a window, then more
    windows in each bucket until it makes one full batch (max_b) and a
    tail batch (<= 16 windows)."""
    by_bucket = {}
    for n in range(1, eng.cfg.max_msa + 2):
        by_bucket.setdefault(eng_mod._bucket_for(n, eng.s_cap), []).append(n)
    tasks = []
    for S, ns in by_bucket.items():
        want = eng._max_b(S) + 3
        for i in range(max(want, len(ns))):
            n = ns[i % len(ns)]
            frags = [rng.integers(0, 4, 12).astype(np.uint8)
                     for _ in range(n)]
            tasks.append(eng_mod.WindowTask(read_key=i, window_idx=0,
                                            pos=(0, 12), frags=frags))
    return tasks


@pytest.mark.parametrize("overrides", [
    {},                                        # correct_preset: 6 buckets
    {"max_msa": 10, "device_lanes": 64},       # 3 buckets, max_b <= 16
    {"max_msa": 200, "n_workers": 2},          # deep -M: slots past 152
])
def test_call_shapes_equal_dispatched_shapes(overrides, monkeypatch):
    cfg = correct_preset(**overrides)
    eng = eng_mod.ConsensusEngine(cfg, device="cpu")
    seen = set()
    lock = threading.Lock()

    def record(sub, S, arrays, rounds):
        B, S_ = arrays[0].shape[:2]
        assert S_ == S and len(sub) <= B
        with lock:
            seen.add((S, B))

    monkeypatch.setattr(eng, "_job_chain", record)
    eng.run(_tasks_filling_every_bucket(eng, np.random.default_rng(0)))
    assert seen == eng.call_shapes()


def _launching_fn(x):
    cuda_align._count("banded_posterior", 4096)
    cuda_align._count("banded_posterior", 1280)
    cuda_align._count("full_posterior", 256)
    return x[:, :2].to(torch.int32) + 1


class StubCall(graph_ops.CapturedCall):
    """A captured call whose card side runs on the CPU: the warm-up and
    the capture run fn, a replay only copies the input in and the
    static output out, as a graph's replay runs no Python."""

    def _warm_up(self):
        self.static_in = torch.zeros(self.in_shape, dtype=torch.uint8)
        self.fn(self.static_in)

    def _capture_graph(self):
        return "graph", self.fn(self.static_in)

    def _replay(self, buf):
        self.static_in.copy_(torch.from_numpy(buf))
        self.static_out.copy_(self.static_in[:, :2].to(torch.int32) + 1)
        return graph_ops.Pending(self.static_out.clone())


def test_replays_add_the_launches_the_capture_recorded():
    try:
        cuda_align.reset_launch_counts()
        call = StubCall(_launching_fn, (3, 5), "cpu")
        call.capture()
        # the warm-up launched; the capture recorded and counted nothing
        assert cuda_align.launch_counts() == {"banded_posterior": 2,
                                              "full_posterior": 1}
        assert call.launches == [("banded_posterior", 4096),
                                 ("banded_posterior", 1280),
                                 ("full_posterior", 256)]
        buf = np.arange(15, dtype=np.uint8).reshape(3, 5)
        for _ in range(3):
            out = call(buf).result()
        np.testing.assert_array_equal(out, buf[:, :2].astype(np.int32) + 1)
        assert cuda_align.launch_counts() == {"banded_posterior": 8,
                                              "full_posterior": 4}
        assert cuda_align.lane_histogram() == {
            "banded_posterior": {1280: 4, 4096: 4},
            "full_posterior": {256: 4}}
        with pytest.raises(ValueError):
            call(buf[:2])
    finally:
        cuda_align.reset_launch_counts()


def test_recording_is_per_thread_and_nests():
    try:
        cuda_align.reset_launch_counts()
        with cuda_align.recording() as outer:
            cuda_align._count("full_posterior", 16)
            with cuda_align.recording() as inner:
                cuda_align._count("full_posterior", 32)
            # another thread's launch while this one records counts
            t = threading.Thread(
                target=cuda_align._count, args=("banded_posterior", 64))
            t.start()
            t.join()
            cuda_align._count("full_posterior", 16)
        assert outer == [("full_posterior", 16), ("full_posterior", 16)]
        assert inner == [("full_posterior", 32)]
        assert cuda_align.launch_counts() == {"banded_posterior": 1,
                                              "full_posterior": 0}
        cuda_align._count("full_posterior", 8)
        assert cuda_align.launch_counts()["full_posterior"] == 1
    finally:
        cuda_align.reset_launch_counts()


def test_captured_calls_need_a_cuda_device():
    with pytest.raises(ValueError):
        graph_ops.captured(("stitch", 8, 128, 128), lambda x: x, (8, 72),
                           "cpu")
    assert graph_ops.Pending(torch.arange(3)).result().tolist() == [0, 1, 2]


def _cumprod_count(x):
    """The count the vote epilogue computed before: an int32 cumprod
    (which returns int64) summed to int32, as the JAX package does."""
    return torch.cumprod(x.to(torch.int32), dim=-1).sum(dim=-1,
                                                        dtype=torch.int32)


@pytest.mark.parametrize("shape", [(5, 37, 16), (9, 16), (4, 3, 2, 16)])
def test_leading_true_equals_cumprod_count(shape):
    rng = np.random.default_rng(len(shape))
    cases = [
        torch.from_numpy(rng.random(shape) < 0.8),         # random rows
        torch.ones(shape, dtype=torch.bool),               # all true
        torch.zeros(shape, dtype=torch.bool),              # all false
    ]
    mixed = torch.from_numpy(rng.random(shape) < 0.5)
    mixed[..., 0, :] = True
    cases.append(mixed)
    for x in cases:
        got = cons_ops._leading_true(x)
        assert got.dtype == torch.int32
        assert torch.equal(got, _cumprod_count(x))
    assert (cons_ops._leading_true(cases[1]) == shape[-1]).all()
    assert (cons_ops._leading_true(cases[2]) == 0).all()


def test_rep_rows_equals_repeat_interleave():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 200, (6, 11)).astype(np.uint8))
    for S in (1, 4, 152):
        assert torch.equal(cons_ops._rep_rows(x, S),
                           x.repeat_interleave(S, dim=0))
        assert torch.equal(cons_ops._rep_rows(x[:, 0], S),
                           x[:, 0].repeat_interleave(S))
