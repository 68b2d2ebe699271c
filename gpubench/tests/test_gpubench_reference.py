"""The plain reference against the port at a small size on the CPU, the
control against the reference, and the batched scorer against
metrics.identity."""

import dataclasses

import numpy as np
import pytest
import torch

from gpubench.gen import make_inputs, simulate
from gpubench.reference import pipeline as ref
from gpubench.reference.flags import config_from_flags
from gpubench.score.identity import identities

PARAMS = {"genome_len": 5000,
          "reads": {"coverage": 8.0, "read_len": 1200,
                    "len_spread": [0.7, 1.3], "error_rate": 0.1,
                    "frac_sub": 1 / 3, "frac_ins": 1 / 3,
                    "reverse_frac": 0.5},
          "contigs": {"n": 2, "min_len": 1500, "draft_error": 0.01}}


def _port(kind, inp):
    from consent_tpu_torch.config import correct_preset, polish_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.overlap import minimizer as mz
    from consent_tpu_torch.pipeline import engine

    cfg = (correct_preset if kind == "correct" else polish_preset)(
        n_workers=2)
    index = ReadIndex()
    for n, c in inp.sequences().items():
        index.add(n, c)
    if kind == "correct":
        piles = list(mz.all_vs_all_piles(inp.queries(), mz.OverlapParams(),
                                         cfg.max_support))
    else:
        piles = list(mz.map_to_targets_piles(
            inp.queries(), [(r.name, r.codes) for r in inp.reads],
            mz.OverlapParams(), cfg.max_support))
    out = {n: (c, s) for n, c, s in engine.process_piles(
        iter(piles), index, cfg, device="cpu")}
    return cfg, {p.q_name: p for p in piles}, out


@pytest.mark.parametrize("kind", ["correct", "polish"])
def test_reference_equals_port_and_control_does_not(kind):
    torch.set_num_threads(2)
    inp = make_inputs(kind, PARAMS, 11)
    cfg, piles, out = _port(kind, inp)
    rcfg = config_from_flags(kind, ["--nproc", "2"])
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    names = sorted(out)[:: max(1, len(out) // 6)]
    if kind == "correct":
        rp = ref.piles_correct(inp.queries(), names, rcfg.max_support)
    else:
        rp = ref.piles_polish(inp.queries(),
                              [(r.name, r.codes) for r in inp.reads], names,
                              rcfg.max_support)
    for n in names:
        assert rp[n].t_names == piles[n].t_names
        assert np.array_equal(rp[n].ov, piles[n].ov)
    want = ref.correct_piles(rp, inp.sequences(), rcfg, "cpu")
    for n in names:
        assert np.array_equal(want[n][0], out[n][0]), n
        assert np.array_equal(want[n][1], out[n][1]), n
    control = ref.correct_piles(rp, inp.sequences(), rcfg, "cpu",
                                score_bits=8)
    differ = sum(not (np.array_equal(control[n][0], want[n][0])
                      and np.array_equal(control[n][1], want[n][1]))
                 for n in names)
    assert differ >= max(1, len(names) // 2)


def test_reference_spans_equal_the_port_aligner():
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.pipeline.device_align import FixedAligner

    cfg = correct_preset()
    rng = np.random.default_rng(4)
    qs, rs = [], []
    for _ in range(12):
        r = rng.integers(0, 4, int(rng.integers(200, 600)), dtype=np.uint8)
        a = int(rng.integers(0, len(r) // 2))
        q = simulate.mutate(rng, r[a: a + int(rng.integers(100, 500))],
                            0.05, 1 / 3, 1 / 3)
        qs.append(q)
        rs.append(r)
    got = FixedAligner(cfg, device="cpu")(qs, rs)
    want = ref.align_spans(qs, rs, ref.stitch_fixed_len(
        config_from_flags("correct", [])), "cpu")
    assert [dataclasses.astuple(g) for g in got] == [
        dataclasses.astuple(w) for w in want]
    bad = ref.align_spans(qs, rs, 640, "cpu", score_bits=8)
    assert [dataclasses.astuple(b) for b in bad] != [
        dataclasses.astuple(w) for w in want]


def test_scorer_equals_metrics_identity():
    from consent_tpu_torch.testing import metrics

    rng = np.random.default_rng(9)
    pairs = []
    for t in range(60):
        a = rng.integers(0, 4, int(rng.integers(1, 1500)), dtype=np.uint8)
        b = simulate.mutate(rng, a, [0.0, 0.02, 0.1, 0.3][t % 4], 1 / 3,
                            1 / 3)
        if t % 5 == 0:
            b = b[int(rng.integers(0, 300)):]      # a trimmed read
        if t % 7 == 0:
            b = rng.integers(0, 4, int(rng.integers(0, 400)), dtype=np.uint8)
        pairs.append((b, a))
    want = [metrics.identity(a, b) for a, b in pairs]
    assert identities(pairs) == want
    assert identities(pairs, band=32, batch=7) == [
        metrics.identity(a, b, 32) for a, b in pairs]
