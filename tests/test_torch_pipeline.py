"""The port's pipeline on the CPU against the JAX package's.

`process_piles` must yield byte-identical (name, codes, solid), both
sides on their default device aligner and with the port's config built
from the JAX one through from_reference."""

import dataclasses

import numpy as np
import pytest
import torch

from consent_tpu.config import correct_preset
from consent_tpu.io.fasta import ReadIndex
from consent_tpu.pipeline import engine as j_engine
from consent_tpu.testing import simulate
from consent_tpu_torch.config import from_reference
from consent_tpu_torch.io.fasta import ReadIndex as TReadIndex
from consent_tpu_torch.pipeline import engine as t_engine
from consent_tpu_torch.testing import simulate as t_simulate

torch.set_num_threads(2)


SIM = dict(genome_len=3000, coverage=14.0, read_len=900,
           error_rate=0.10, seed=42)     # the tests/test_e2e.py simulation


@pytest.fixture(scope="module")
def sim():
    return simulate.simulate(**SIM), t_simulate.simulate(**SIM)


def test_simulation_copy_matches(sim):
    (genome, reads), (g2, r2) = sim
    assert np.array_equal(genome, g2)
    def key(r):
        return (r.name, r.codes.tobytes(), r.g_beg, r.g_end, r.reverse,
                r.g2r.tobytes())

    assert [key(r) for r in reads] == [key(r) for r in r2]


# three piles keep every fragment bucket at the 16-window tail batch
@pytest.mark.parametrize("rounds,warm_frac", [(2, 0.25), (2, 1.0), (1, 1.0)])
def test_process_piles_matches_jax(sim, rounds, warm_frac):
    n_piles = 3
    (_, reads), (_, t_reads) = sim
    j_cfg = correct_preset(window_size=200, window_overlap=20,
                           min_support=3, consensus_rounds=rounds,
                           warm_frac=warm_frac, n_workers=2)
    t_cfg = from_reference(dataclasses.asdict(j_cfg))
    j_index, t_index = ReadIndex(), TReadIndex()
    for r in reads:
        j_index.add(r.name, r.codes)
        t_index.add(r.name, r.codes)
    j_piles = simulate.piles_from_sim(reads, j_cfg.max_support)[:n_piles]
    t_piles = t_simulate.piles_from_sim(
        t_reads, t_cfg.max_support)[:n_piles]
    want = list(j_engine.process_piles(iter(j_piles), j_index, j_cfg))
    got = list(t_engine.process_piles(iter(t_piles), t_index, t_cfg,
                                      device="cpu"))
    assert len(want) == len(got) == n_piles
    assert sum(len(c) > 0 for _, c, _ in got) > 0
    for (n1, c1, s1), (n2, c2, s2) in zip(want, got):
        assert n1 == n2
        assert np.array_equal(c1, c2), n1
        assert np.array_equal(s1, s2), n1
