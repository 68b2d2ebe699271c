"""The port's vectorised window geometry (`engine.windows_of_pile`,
`engine.windows_of_piles`, `engine.clip_piles`) against a per-window
oracle: `clip_fragments` of core/windows.py called once per window.

Each case builds one situation, checks that the situation is there
(so that no case passes vacuously), then compares the window count,
positions, fragment bytes and start offsets (`d0s`)."""

import numpy as np
import pytest

from consent_tpu_torch.config import correct_preset, polish_preset
from consent_tpu_torch.core import windows as win_mod
from consent_tpu_torch.io.fasta import ReadIndex
from consent_tpu_torch.io.paf import OVERLAP_DTYPE, Pile
from consent_tpu_torch.overlap import minimizer as mz
from consent_tpu_torch.pipeline import engine
from consent_tpu_torch.testing import simulate

CFG = correct_preset(window_size=200, window_overlap=20, min_support=1)


def oracle(pile, seq_map, pos, mer_size):
    return [win_mod.clip_fragments(pile, seq_map, b, e, mer_size,
                                   with_offsets=True) for b, e in pos]


def positions(pile, seq_map, cfg):
    q_len = len(seq_map[pile.q_name])
    return win_mod.window_positions(
        q_len, win_mod.coverage(q_len, pile.ov), cfg.min_support,
        cfg.window_size, cfg.window_overlap)


def admitted(pile, pos):
    """(window, row) pairs clip_fragments admits (its rule, :117)."""
    out = []
    for w, (b, e) in enumerate(pos):
        for r, o in enumerate(pile.ov):
            q0, q1, t0, t1 = (int(o[k]) for k in
                              ("q_start", "q_end", "t_start", "t_end"))
            shift = b - q0 if b > q0 else 0
            if (((q0 <= b and q1 > b) or (e <= q1 and q0 < e))
                    and t0 + shift <= t1):
                out.append((w, r))
    return out


def synthetic(q_len, rows, seed=0):
    """A pile of random template and targets; rows are (q_start, q_end,
    strand, t_len, t_start, t_end)."""
    rng = np.random.default_rng(seed)
    index = ReadIndex()
    index.add("q", rng.integers(0, 4, q_len, dtype=np.uint8))
    names = []
    for i, (_, _, _, t_len, _, _) in enumerate(rows):
        names.append(f"t{i}")
        index.add(names[-1], rng.integers(0, 4, t_len, dtype=np.uint8))
    ov = np.array([(q_len, qs, qe, st, tl, ts, te, 0, 0, 0)
                   for qs, qe, st, tl, ts, te in rows], dtype=OVERLAP_DTYPE)
    return Pile(q_name="q", t_names=names, ov=ov), index


def random_rows(rng, q_len, n, strand=None):
    rows = []
    for _ in range(n):
        qs = int(rng.integers(0, q_len - 60))
        qe = int(rng.integers(qs + 40, q_len))
        t_len = int(rng.integers(qe - qs + 1, qe - qs + 400))
        ts = int(rng.integers(0, t_len - (qe - qs)))
        te = min(t_len - 1, ts + (qe - qs) + int(rng.integers(-30, 30)))
        st = bool(rng.integers(0, 2)) if strand is None else strand
        rows.append((qs, qe, st, t_len, ts, max(te, ts)))
    return rows


def case_sim_correct():
    _, reads = simulate.simulate(genome_len=3000, coverage=14.0,
                                 read_len=900, error_rate=0.10, seed=42)
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    return simulate.piles_from_sim(reads, CFG.max_support), index, CFG


def case_overlapper_correct():
    _, reads = simulate.simulate(genome_len=6000, coverage=10.0,
                                 read_len=1200, error_rate=0.10, seed=7)
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    cfg = correct_preset(window_size=200, window_overlap=20)
    piles = list(mz.all_vs_all_piles([(r.name, r.codes) for r in reads],
                                     mz.OverlapParams(), cfg.max_support))
    return piles, index, cfg


def case_polish_contig():
    genome, reads = simulate.simulate(genome_len=4000, coverage=10.0,
                                      read_len=700, error_rate=0.08, seed=21)
    draft, _ = simulate.mutate(genome, np.random.default_rng(1), 0.02)
    index = ReadIndex()
    index.add("contig1", draft)
    for r in reads:
        index.add(r.name, r.codes)
    cfg = polish_preset(window_size=200, window_overlap=20)
    piles = list(mz.map_to_targets_piles(
        [("contig1", draft)], [(r.name, r.codes) for r in reads],
        mz.OverlapParams(), cfg.max_support))
    return piles, index, cfg


def case_minus_strand():
    rng = np.random.default_rng(3)
    pile, index = synthetic(1000, random_rows(rng, 1000, 24, strand=True))
    return [pile], index, CFG


def case_clipped():
    # rows starting and ending inside windows, and a target too short
    # to fill a left clip
    rows = [(250, 900, False, 800, 30, 680), (0, 430, True, 500, 40, 470),
            (100, 999, False, 1200, 0, 899), (0, 999, True, 1000, 0, 999),
            (390, 700, True, 340, 10, 330), (600, 999, False, 410, 5, 404)]
    pile, index = synthetic(1000, rows, seed=4)
    return [pile], index, CFG


def case_short_dropped():
    # right clip near the target's end and a left clip on a 5-base
    # target: admitted, shorter than mer_size
    rows = [(0, 999, False, 1000, 0, 999), (0, 183, False, 186, 0, 183),
            (376, 800, False, 5, 0, 4)]
    pile, index = synthetic(1000, rows, seed=5)
    return [pile], index, CFG


def case_off_template():
    rows = [(0, 999, False, 1000, 0, 999), (100, 900, True, 900, 50, 850)]
    pile, index = synthetic(1000, rows, seed=6)
    return [pile], index, CFG


def case_duplicated_right_window():
    # coverage ends at 739: the forward pass's last window is (540, 739),
    # and the right-anchored window repeats it
    rows = [(0, 739, False, 800, 10, 749), (0, 500, True, 600, 0, 500),
            (300, 739, True, 700, 100, 539)]
    pile, index = synthetic(1000, rows, seed=8)
    return [pile], index, CFG


def case_t_span_zero():
    rows = [(0, 999, False, 1000, 0, 999), (250, 600, False, 1000, 100, 100),
            (190, 650, True, 700, 300, 300)]
    pile, index = synthetic(1000, rows, seed=9)
    return [pile], index, CFG


def case_half_d0():
    # q span / t span = 1/2 and an odd shift: the column lands on .5
    rows = [(0, 999, False, 1000, 0, 999), (101, 701, False, 1300, 0, 1200),
            (103, 703, False, 1300, 0, 1200)]
    pile, index = synthetic(1000, rows, seed=10)
    return [pile], index, CFG


def case_no_window():
    rows = [(10, 150, False, 300, 0, 140), (400, 520, True, 200, 20, 140)]
    pile, index = synthetic(1000, rows, seed=11)
    return [pile], index, CFG


def check_sim(piles, index, cfg, pos):
    assert sum(len(p) for p in pos) > 20


def check_minus(piles, index, cfg, pos):
    (pile,), (p,) = piles, pos
    assert pile.ov["strand"].all() and len(admitted(pile, p)) > 20


def check_clipped(piles, index, cfg, pos):
    (pile,), (p,) = piles, pos
    ov = pile.ov
    pairs = admitted(pile, p)
    assert any(p[w][0] < ov["q_start"][r] for w, r in pairs)     # left
    assert any(ov["q_end"][r] < p[w][1] for w, r in pairs)       # right


def check_dropped(piles, index, cfg, pos):
    (pile,), (p,) = piles, pos
    seq_map = win_mod.sequences_map(pile, index)
    emitted = sum(len(f) - 1 for f, _ in oracle(pile, seq_map, p,
                                                cfg.mer_size))
    assert emitted < len(admitted(pile, p))


def check_duplicated(piles, index, cfg, pos):
    (p,) = pos
    assert p[-1] in p[:-1]


def check_t_span_zero(piles, index, cfg, pos):
    (pile,), (p,) = piles, pos
    ov = pile.ov
    assert {r for _, r in admitted(pile, p)
            if ov["t_start"][r] == ov["t_end"][r]} == {1, 2}


def check_half_d0(piles, index, cfg, pos):
    (pile,), (p,) = piles, pos
    halves = 0
    for w, r in admitted(pile, p):
        o, b = pile.ov[r], p[w][0]
        if r and b > o["q_start"]:
            shift = b - int(o["q_start"])
            scale = (int(o["q_end"]) - int(o["q_start"])) / (
                int(o["t_end"]) - int(o["t_start"]))
            qcol = int(o["q_start"]) + shift * scale
            halves += qcol % 1 == 0.5
    assert halves >= 2


def check_no_window(piles, index, cfg, pos):
    assert pos == [[]]


CASES = {
    "sim_correct": (case_sim_correct, check_sim),
    "overlapper_correct": (case_overlapper_correct, check_sim),
    "polish_contig": (case_polish_contig, check_sim),
    "minus_strand": (case_minus_strand, check_minus),
    "left_right_clipped": (case_clipped, check_clipped),
    "short_dropped": (case_short_dropped, check_dropped),
    "duplicated_right_window": (case_duplicated_right_window,
                                check_duplicated),
    "t_span_zero": (case_t_span_zero, check_t_span_zero),
    "d0_on_half": (case_half_d0, check_half_d0),
    "no_window": (case_no_window, check_no_window),
}


def assert_same(got_frags, got_d0s, want):
    assert len(got_frags) == len(got_d0s) == len(want)
    for f, d, (wf, wd) in zip(got_frags, got_d0s, want):
        assert [x.tobytes() for x in f] == [x.tobytes() for x in wf]
        assert list(d) == list(wd)
        assert all(type(x) is int for x in d)


def assert_tasks(tasks, key, pile, seq_map, pos, mer_size):
    if not pos:
        assert tasks is None
        return
    assert [t.pos for t in tasks] == pos
    assert [t.window_idx for t in tasks] == list(range(len(pos)))
    assert {t.read_key for t in tasks} == {key}
    assert_same([t.frags for t in tasks], [t.d0s for t in tasks],
                oracle(pile, seq_map, pos, mer_size))


@pytest.mark.parametrize("case", list(CASES))
def test_windows_of_pile_matches_per_window_clipping(case):
    make, check = CASES[case]
    piles, index, cfg = make()
    maps = [win_mod.sequences_map(p, index) for p in piles]
    pos = [positions(p, m, cfg) for p, m in zip(piles, maps)]
    check(piles, index, cfg, pos)
    for key, (pile, seq_map, p) in enumerate(zip(piles, maps, pos)):
        tasks = engine.windows_of_pile(pile, index, cfg, key)
        assert_tasks(tasks, key, pile, seq_map, p, cfg.mer_size)


@pytest.mark.parametrize("n_piles", [40, 7, 1])
@pytest.mark.parametrize("case", ["sim_correct", "overlapper_correct",
                                  "polish_contig"])
def test_windows_of_piles_in_passes_match_pile_by_pile(
        case, n_piles, monkeypatch):
    """Several piles, or one alone, in one vectorised pass give every
    pile what the per-window oracle gives it."""
    passes = []
    clip = engine.clip_piles

    def counted(piles, seq_maps, poss, mer_size):
        passes.append([len(p) for p in poss])
        return clip(piles, seq_maps, poss, mer_size)

    monkeypatch.setattr(engine, "clip_piles", counted)
    piles, index, cfg = CASES[case][0]()
    piles = piles[:n_piles]
    got = engine.windows_of_piles(piles, index, cfg, first_key=5)
    assert len(got) == len(piles)
    # one pass over every pile's windows
    assert len(passes) == 1 and len(passes[0]) == len(piles)
    for k, (pile, tasks) in enumerate(zip(piles, got)):
        seq_map = win_mod.sequences_map(pile, index)
        assert_tasks(tasks, 5 + k, pile, seq_map,
                     positions(pile, seq_map, cfg), cfg.mer_size)


def test_clip_piles_window_off_template():
    """A window past the stored template's end gets no fragment, as
    clip_fragments' guard gives; windows_of_pile never asks for one."""
    (pile,), index, cfg = case_off_template()
    seq_map = win_mod.sequences_map(pile, index)
    pos = [(0, 199), (900, 1099), (180, 379), (801, 1000), (799, 998)]
    frags, d0s, n_pairs = engine.clip_piles([pile], [seq_map], [pos],
                                            cfg.mer_size)
    assert frags[1] == frags[3] == [] and d0s[1] == d0s[3] == []
    assert all(len(f) == 3 for k, f in enumerate(frags) if k in (0, 2, 4))
    assert n_pairs == 2 * len(pos)
    assert_same(frags, d0s, oracle(pile, seq_map, pos, cfg.mer_size))


def test_clip_piles_enumerates_only_intersecting_pairs():
    """The pairs examined are those whose query spans intersect, far
    fewer than windows x overlaps on a long contig."""
    rng = np.random.default_rng(12)
    q_len = 20000
    rows = []
    for _ in range(300):
        qs = int(rng.integers(0, q_len - 800))
        qe = qs + int(rng.integers(300, 800))
        rows.append((qs, qe, bool(rng.integers(0, 2)), 1000, 50,
                     50 + qe - qs))
    pile, index = synthetic(q_len, rows, seed=13)
    seq_map = win_mod.sequences_map(pile, index)
    pos = positions(pile, seq_map, CFG)
    frags, d0s, n_pairs = engine.clip_piles([pile], [seq_map], [pos],
                                            CFG.mer_size)
    ov = pile.ov
    want_pairs = sum(int(((ov["q_start"] <= e) & (ov["q_end"] >= b)).sum())
                     for b, e in pos)
    assert n_pairs == want_pairs < len(pos) * len(ov) // 10
    assert_same(frags, d0s, oracle(pile, seq_map, pos, CFG.mer_size))


def test_clip_piles_uneven_windows_and_piles():
    """Windows of uneven widths (a wide one ending after later ones) and
    piles of very different lengths in one pass: the candidate search
    keeps to each pile and reaches every intersecting window."""
    rng = np.random.default_rng(14)
    piles, maps, poss = [], [], []
    for k, q_len in enumerate((30000, 900, 12000, 1500)):
        pile, index = synthetic(q_len, random_rows(rng, q_len, 30), seed=k)
        piles.append(pile)
        maps.append(win_mod.sequences_map(pile, index))
        starts = np.sort(rng.integers(0, q_len - 700, 12))
        widths = rng.integers(50, 700, 12)
        poss.append([(int(s), int(s + w)) for s, w in zip(starts, widths)]
                    + [(0, q_len - 5)])
    frags, d0s, n_pairs = engine.clip_piles(piles, maps, poss, CFG.mer_size)
    want = [x for p, m, pos in zip(piles, maps, poss)
            for x in oracle(p, m, pos, CFG.mer_size)]
    assert_same(frags, d0s, want)
    # uneven widths: a superset of the intersecting pairs, in its pile
    assert sum(int(((p.ov["q_start"] <= e) & (p.ov["q_end"] >= b)).sum())
               for p, pos in zip(piles, poss) for b, e in pos) <= n_pairs
    assert n_pairs <= sum(len(p.ov) * len(pos) for p, pos in zip(piles, poss))
