"""The native stitch table (pipeline/stitch_rounds.py,
native/stitch_rounds.cpp) against stitch.run_stitch, on the CPU.

Random jobs of small windows (window 20, overlap 4, k = 5, so the plain
aligner stays cheap) are stitched twice with the same aligner, once as
StitchJobs through run_stitch and once as one table, and every output
must be the same bytes, codes and case.  The jobs reach every branch of
the apply: the template in place of a consensus shorter than k, spans
with no alignment, overlap arbitration by solid k-mers and by solid
bases, the previous window's overlap kept (the sub-alignment's cut),
splices longer than their query's span (at the table's exact
capacities), one-window reads, empty piles, and groups of rounds above
and at or below the host aligner's 8 lanes.  A round's requests must
read as the jobs' own, and their native wire rows must equal the padded
layout packed in NumPy."""

import numpy as np
import pytest
import torch

from consent_tpu_torch.config import correct_preset
from consent_tpu_torch.core.sparse_counts import SparseCounts
from consent_tpu_torch.io import seqs
from consent_tpu_torch.ops.consensus import pack_bases_host
from consent_tpu_torch.ops import kmer as kmer_ops
from consent_tpu_torch.parallel import mesh as mesh_mod
from consent_tpu_torch.pipeline import device_align
from consent_tpu_torch.pipeline import stitch as st
from consent_tpu_torch.pipeline import stitch_rounds as sr
from consent_tpu_torch.utils.observe import StageStats

torch.set_num_threads(2)

CFG = correct_preset(window_size=20, window_overlap=4, mer_size=5,
                     min_support=1, frag_slack=16)


def _mutate(rng, s, rate):
    out = []
    for b in s:
        u = rng.random()
        if u < rate / 3:
            continue                            # deletion
        if u < 2 * rate / 3:
            out.append(int(rng.integers(0, 4)))  # insertion
        elif u < rate:
            b = (b + 1 + int(rng.integers(0, 3))) % 4
        out.append(int(b))
    return np.array(out, dtype=np.uint8)


def _counts(cfg, codes, mult):
    dense = kmer_ops.count_kmers_host([codes, codes], cfg.mer_size)
    return SparseCounts.from_dense(dense * mult)


def random_spec(rng, n_jobs, cfg=CFG, max_windows=None, cons_err=0.05):
    """n_jobs reads, each (raw, piles_pos, consensuses, templates,
    counts): windows 15-25 long at steps of 6-19 (overlaps both below
    and above k), consensuses the truth with `cons_err` error, some cut
    below k or empty, some templates empty, counts solid or not at
    random."""
    spec = []
    for _ in range(n_jobs):
        true = rng.integers(0, 4, int(rng.integers(30, 140))).astype(np.uint8)
        raw = _mutate(rng, true, 0.1)
        pos, cons, tpls, cnts = [], [], [], []
        p = 0
        while p < len(raw) - 5 and (max_windows is None
                                     or len(pos) < max_windows):
            w = int(rng.integers(15, 26))
            e = min(len(raw) - 1, p + w - 1)
            c = _mutate(rng, true[p : p + w + 2], cons_err)
            u = rng.random()
            if u < 0.03:
                c = c[:0]
            elif u < 0.08:
                c = c[:3]
            tpl = raw[p : e + 1] if rng.random() > 0.05 else raw[:0]
            pos.append((p, e))
            cons.append((c, rng.random(len(c)) < 0.7))
            tpls.append(tpl)
            cnts.append(_counts(cfg, c, int(rng.integers(1, 6))))
            p += int(rng.integers(6, 20))
        spec.append((raw, pos, cons, tpls, cnts))
    return spec


def jobs_of(spec, cfg=CFG):
    return [st.StitchJob(f"r{i}", raw, pos, cons, tpls, cnts, cfg)
            for i, (raw, pos, cons, tpls, cnts) in enumerate(spec)]


def table_of(jobs):
    """The table of StitchJobs not yet started (the same inputs)."""
    win_off = np.zeros(len(jobs) + 1, dtype=np.int64)
    np.cumsum([len(j.consensuses) for j in jobs], out=win_off[1:])
    cons = [c for j in jobs for c in j.consensuses]
    templates = [t for j in jobs for t in j.templates]
    return sr.StitchTable(
        jobs[0].cfg, [j.out_c for j in jobs], win_off,
        np.array([p[0] for j in jobs for p in j.piles_pos], np.int64),
        [c for c, _ in cons], [s for _, s in cons],
        [c for j in jobs for c in j.counts], templates.__getitem__)


def branches_of(spec, aligner):
    """The apply branches run_stitch takes on spec, classified from each
    job's state before its window is applied."""
    k = CFG.mer_size
    hits = set()

    def classify(job, span):
        if not span.valid:
            hits.add("skip")
            return
        cons_c, cons_s = job._cur_cons
        raw_len = len(job.consensuses[job.i][0])
        if raw_len < k:
            hits.add("template")
        beg = span.r_begin + job._al_pos
        cur_c = cons_c[span.q_begin : span.q_end + 1]
        cur_s = cons_s[span.q_begin : span.q_end + 1]
        if not (job.i and job.old_end >= beg and job.old_cons is not None):
            return
        ov = job.old_end - beg + 1
        old_c, old_s = job.old_cons
        if (raw_len < k or len(old_c) < ov or len(cur_c) < ov
                or np.array_equal(old_c[len(old_c) - ov :], cur_c[:ov])):
            return
        if ov >= k:
            hits.add("overlap_kmers")
            sm1 = job.old_mers.n_solid(
                seqs.kmer_codes(old_c[len(old_c) - ov :], k),
                CFG.solid_thresh)
            sm2 = job.counts[job.i].n_solid(seqs.kmer_codes(cur_c[:ov], k),
                                            CFG.solid_thresh)
        else:
            hits.add("overlap_bases")
            sm1 = np.count_nonzero(old_s[len(old_s) - ov :])
            sm2 = np.count_nonzero(cur_s[:ov])
        if sm1 > sm2:
            hits.add("keep_old")

    def grew(job, span, old):
        # the tracked splice is longer than its query's aligned span
        if (span.valid and job.old_cons is not old
                and len(job.old_cons[0]) > span.q_end - span.q_begin + 1):
            hits.add("splice_past_query")

    mp = pytest.MonkeyPatch()
    apply, apply_round = st.StitchJob.apply, st._apply_round_native

    def one(job, span):
        classify(job, span)
        old = job.old_cons
        apply(job, span)
        grew(job, span, old)

    def round_(jobs, spans):
        for job, span in zip(jobs, spans):
            classify(job, span)
        olds = [job.old_cons for job in jobs]
        done = apply_round(jobs, spans)
        if done:
            for job, span, old in zip(jobs, spans, olds):
                grew(job, span, old)
        return done

    mp.setattr(st.StitchJob, "apply", one)
    mp.setattr(st, "_apply_round_native", round_)
    try:
        st.run_stitch(jobs_of(spec), aligner)
    finally:
        mp.undo()
    return hits


class Recording:
    """A wrapper of the aligner's dispatch/collect, as the benchmark's
    CountingAligner wraps it: the lanes of every round."""

    def __init__(self, inner):
        self.inner = inner
        self.lanes = []

    def dispatch(self, qs, rs):
        self.lanes.append(len(qs))
        return self.inner.dispatch(qs, rs)

    def collect(self, handle):
        return self.inner.collect(handle)


def stitch_both(spec, aligner, monkeypatch):
    """(run_stitch's outputs, the table's outputs, the table's counts,
    the lanes of the table's rounds)."""
    want = jobs_of(spec)
    st.run_stitch(want, aligner)
    stats = StageStats()
    monkeypatch.setattr(sr, "STATS", stats)
    monkeypatch.setattr(device_align, "STATS", stats)
    rec = Recording(aligner)
    with table_of(jobs_of(spec)) as table:
        table.run(rec)
        got = table.results()
    return [j.result() for j in want], got, dict(stats.counts), rec.lanes


class HostSmallAligner(device_align.FixedAligner):
    """The card's routing on the CPU: batches of at most 8 lanes to the
    native host aligner."""

    def _small_on_host(self):
        return True


def cpu_aligner(host_small=False, shards=1):
    mesh = (mesh_mod.make_data_mesh(["cpu"] * shards) if shards > 1
            else None)
    cls = HostSmallAligner if host_small else device_align.FixedAligner
    return cls(CFG, device="cpu", mesh=mesh)


# seed, jobs, the consensuses' error, the host aligner for rounds of <= 8
# lanes, the aligner's shards; the long_splices cases' noisy consensuses
# make the kept overlaps and their cuts longest
CASES = {
    "branches": (1, 40, 0.05, False, 1),
    "long_splices_a": (2, 24, 0.2, False, 1),
    "long_splices_b": (3, 24, 0.3, False, 1),
    "host_lanes": (4, 40, 0.05, True, 1),
    "few_jobs_one_group": (5, 5, 0.05, True, 1),
    "two_shard_mesh": (6, 30, 0.05, False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_equals_run_stitch(case, monkeypatch):
    seed, n_jobs, cons_err, host_small, shards = CASES[case]
    rng = np.random.default_rng(seed)
    spec = random_spec(rng, n_jobs, cons_err=cons_err)
    # a one-window read and an empty pile in every case
    spec.append(random_spec(rng, 1, max_windows=1)[0])
    spec.append((rng.integers(0, 4, 50).astype(np.uint8), [], [], [], []))
    aligner = cpu_aligner(host_small, shards)
    want, got, counts, lanes = stitch_both(spec, aligner, monkeypatch)
    assert len(got) == len(want)
    for (wc, ws), (gc, gs) in zip(want, got):
        assert gc.tobytes() == wc.tobytes()
        assert gs.dtype == bool and gs.tobytes() == ws.tobytes()
    assert got[-1][0].tobytes() == spec[-1][0].tobytes()
    assert not got[-1][1].any()

    n_windows = sum(len(s[1]) for s in spec)
    assert counts["stitch.windows_native"] == n_windows
    assert counts["stitch.rounds_native"] == len(lanes)
    assert counts["stitch.align"] == sum(lanes) == counts["stitch.apply"]
    assert (counts.get("stitch.host_lanes", 0) > 0) == host_small
    if case == "branches":
        hits = branches_of(spec, aligner)
        assert hits >= {"skip", "template", "overlap_kmers",
                        "overlap_bases", "keep_old"}, hits
    if case.startswith("long_splices"):
        assert "splice_past_query" in branches_of(spec, aligner)
    small = device_align.NATIVE_MAX_LANES
    assert min(lanes) <= small
    if n_jobs >= 16:
        assert max(lanes) > small
    assert (counts.get("stitch.host_lanes", 0)
            == (sum(n for n in lanes if n <= small) if host_small else 0))


def realistic_spec(rng, n_jobs, cfg):
    """One window a job at the main path's sizes: consensuses of 450-700
    bases (past the pinned length now and then), windows anywhere in
    reads of 600-1,400 bases, so some slabs end at the read's end."""
    spec = []
    for _ in range(n_jobs):
        raw = rng.integers(0, 4, int(rng.integers(600, 1400))).astype(
            np.uint8)
        p = int(rng.integers(0, len(raw) - 100))
        c = rng.integers(0, 4, int(rng.integers(450, 700))).astype(np.uint8)
        empty = SparseCounts(np.empty(0, np.int64), np.empty(0, np.int32))
        spec.append((raw, [(p, p + cfg.window_size - 1)],
                     [(c, np.ones(len(c), bool))], [raw[p : p + 500]],
                     [empty]))
    return spec


def numpy_wire(qs, rs, fixed_len, n_shards):
    """The wire rows _spans_wire_body reads, built in NumPy: lanes a
    power of two per shard, lengths multiples of 128 and at least
    fixed_len, q and r padded with 0 and packed by pack_bases_host, then
    the int32 lengths; the lanes past the pairs zero."""
    n = len(qs)
    per = device_align._next_pow2(-(-n // n_shards))
    lanes = n_shards * per
    Lq = max(device_align._round_up(max(map(len, qs)), 128), fixed_len)
    Lr = max(device_align._round_up(max(map(len, rs)), 128), fixed_len)
    q = np.zeros((lanes, Lq), dtype=np.uint8)
    r = np.zeros((lanes, Lr), dtype=np.uint8)
    ln = np.zeros((lanes, 2), dtype=np.int32)
    for i, (a, b) in enumerate(zip(qs, rs)):
        q[i, : len(a)] = a
        r[i, : len(b)] = b
        ln[i] = len(a), len(b)
    buf = np.concatenate(
        [pack_bases_host(q), pack_bases_host(r), ln.view(np.uint8)], axis=1)
    return buf, per, Lq, Lr


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("lanes", [16, 256, 1024])
def test_packed_wire_equals_device_align_buffer(lanes, shards):
    """A round's requests, taken from the table, are the jobs' own, and
    device_align packs them natively into the same bytes as the padded
    layout built in NumPy, split into the same shards."""
    cfg = correct_preset()
    rng = np.random.default_rng(lanes + shards)
    jobs = jobs_of(realistic_spec(rng, lanes, cfg), cfg)
    fixed_len = device_align.FixedAligner(cfg, device="cpu").fixed_len
    with table_of(jobs) as table:
        pairs = table.requests(np.arange(lanes, dtype=np.int64))
    qs, rs = zip(*(j.next_request() for j in jobs))
    buf, per, Lq, Lr = device_align._wire_buffer(pairs, fixed_len, shards)
    want = numpy_wire(qs, rs, fixed_len, shards)
    assert (per, Lq, Lr) == want[1:]
    assert Lq > fixed_len        # a consensus past the pinned length
    assert buf.shape == want[0].shape
    assert buf.tobytes() == want[0].tobytes()
    got_qs, got_rs = pairs.sides()
    assert len(got_qs) == len(got_rs) == lanes
    for i in range(0, lanes, 7):
        assert got_qs[i].tobytes() == qs[i].tobytes()
        assert got_rs[i].tobytes() == rs[i].tobytes()


def test_pairs_dispatch_as_lists_do():
    """The sides of a table's requests, dispatched as they are, give the
    spans of the same requests dispatched as lists of arrays."""
    rng = np.random.default_rng(9)
    jobs = jobs_of(random_spec(rng, 12))
    aligner = cpu_aligner()
    with table_of(jobs) as table:
        pairs = table.requests(np.arange(12, dtype=np.int64))
    got = aligner.collect(aligner.dispatch(*pairs.sides()))
    qs, rs = zip(*(j.next_request() for j in jobs))
    want = aligner.collect(aligner.dispatch(list(qs), list(rs)))
    assert got.rows.tobytes() == want.rows.tobytes()
    assert list(got) == list(want)


def test_a_span_outside_its_pair_raises():
    """A splice past the table's capacities is a fault of the span, not
    a case to apply: the apply raises."""
    rng = np.random.default_rng(10)
    jobs = jobs_of(random_spec(rng, 4))
    with table_of(jobs) as table:
        ids = np.arange(4, dtype=np.int64)
        pairs = table.requests(ids)
        rows = np.zeros((4, 5), dtype=np.int32)
        rows[:, 1] = pairs.q_len - 1
        rows[:, 2] = 10 ** 6          # r_begin past the read's end
        rows[:, 3] = 0
        rows[:, 4] = 1
        with pytest.raises(RuntimeError, match="capacity"):
            table.apply(ids, rows)
