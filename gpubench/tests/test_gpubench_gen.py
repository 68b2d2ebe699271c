"""The generator: the same seed gives the same inputs, every seed the
same sizes, and the error model's rates."""

import numpy as np
import pytest

from gpubench.gen import make_inputs, simulate
from gpubench.tests.helpers import load_cell

PARAMS = {"genome_len": 20000,
          "reads": {"coverage": 10.0, "read_len": 2000,
                    "len_spread": [0.7, 1.3], "error_rate": 0.1,
                    "frac_sub": 1 / 3, "frac_ins": 1 / 3,
                    "reverse_frac": 0.5},
          "contigs": {"n": 5, "min_len": 2000, "draft_error": 0.01}}


def _flat(inp):
    return [(n, c.tobytes()) for n, c in inp.queries()] + [
        (r.name, r.codes.tobytes(), r.g_beg, r.reverse) for r in inp.reads]


@pytest.mark.parametrize("kind", ["correct", "polish"])
def test_same_seed_same_inputs(kind):
    seed = 2 ** 31 + 12345          # past 32 signed bits
    a = make_inputs(kind, PARAMS, seed)
    b = make_inputs(kind, PARAMS, seed)
    c = make_inputs(kind, PARAMS, seed + 1)
    assert _flat(a) == _flat(b)
    assert _flat(a) != _flat(c)


def test_every_seed_has_the_same_sizes():
    a = make_inputs("polish", PARAMS, 1)
    b = make_inputs("polish", PARAMS, 2)
    assert sorted(r.g_end - r.g_beg for r in a.reads) == sorted(
        r.g_end - r.g_beg for r in b.reads)
    assert sum(r.reverse for r in a.reads) == sum(r.reverse for r in b.reads)
    la = sorted(len(t) for t in a.truth_contigs.values())
    assert la == sorted(len(t) for t in b.truth_contigs.values())
    assert sum(la) == PARAMS["genome_len"] and min(la) >= 2000


def test_truth_is_the_read_without_its_errors():
    p = {**PARAMS, "reads": {**PARAMS["reads"], "error_rate": 0.0}}
    inp = make_inputs("correct", p, 3)
    for r in inp.reads:
        assert np.array_equal(r.codes, inp.truth(r.name))
    pol = make_inputs("polish", {**p, "contigs": {**p["contigs"],
                                                  "draft_error": 0.0}}, 3)
    for name, draft in pol.draft.items():
        assert np.array_equal(draft, pol.truth(name))
    assert np.array_equal(np.concatenate(list(pol.truth_contigs.values())),
                          pol.genome)


def test_error_rates():
    rng = np.random.default_rng(5)
    n = 400_000
    g = simulate.genome(rng, n)
    out = simulate.mutate(rng, g, 0.1, 1 / 3, 1 / 3)
    # insertions add a base and deletions remove one: equal thirds keep
    # the length, and the share of bases kept equal is 1 - sub - del
    assert abs(len(out) - n) / n < 0.003
    from consent_tpu_torch.testing.metrics import edit_distance_banded
    d = edit_distance_banded(out[:4000], g[:4000], 256)
    assert 0.08 < d / 4000 < 0.12


def test_committed_traffic_sizes():
    """The committed mixes are upstream's example: 3.35 Mb at 10x of
    4 kb reads, 86 contigs for polishing."""
    for cell in ("correct-10x", "polish-10x"):
        t = load_cell(cell).traffic
        assert t["genome_len"] == 3_350_000
        assert t["reads"]["coverage"] == 10.0
        assert t["reads"]["read_len"] == 4000
    assert load_cell("polish-10x").traffic["contigs"]["n"] == 86
