"""The port's consent-polish on the CPU against the JAX package's, and
the Python host fallbacks of the host post chain: the same inputs must
give the same bytes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consent_tpu import cli as j_cli
from consent_tpu import config as j_config
from consent_tpu import native as j_native
from consent_tpu.io import seqs
from consent_tpu.io.fasta import ReadIndex
from consent_tpu.ops import align as j_align
from consent_tpu.ops import consensus as j_cons
from consent_tpu.ops import kmer as j_kmer
from consent_tpu.overlap import minimizer as j_mz
from consent_tpu.pipeline import engine as j_engine
from consent_tpu.testing import simulate
from consent_tpu_torch import cli as t_cli
from consent_tpu_torch import native as t_native
from consent_tpu_torch.config import from_reference, polish_preset
from consent_tpu_torch.io.fasta import ReadIndex as TReadIndex
from consent_tpu_torch.ops import align as t_align
from consent_tpu_torch.ops import consensus as t_cons
from consent_tpu_torch.ops import kmer as t_kmer
from consent_tpu_torch.overlap import minimizer as t_mz
from consent_tpu_torch.pipeline import engine as t_engine

torch.set_num_threads(2)

SMALL = ["--windowSize", "200", "--windowOverlap", "20",
         "--overlapper", "native", "--nproc", "2"]


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    """tests/test_cli.py's small dataset: a 2 kb contig at 2% error and
    10x reads of 700 bases at 8% error."""
    tmp = tmp_path_factory.mktemp("polish")
    genome, reads = simulate.simulate(
        genome_len=2000, coverage=10.0, read_len=700,
        error_rate=0.08, seed=21,
    )
    reads_fa = tmp / "reads.fasta"
    with open(reads_fa, "w") as f:
        for r in reads:
            f.write(f">{r.name}\n{seqs.decode(r.codes)}\n")
    codes, _ = simulate.mutate(genome, np.random.default_rng(1), 0.02)
    asm_fa = tmp / "draft.fasta"
    asm_fa.write_text(f">contig1\n{seqs.decode(codes)}\n")
    return tmp, reads_fa, asm_fa


def test_polish_preset_matches_jax():
    assert from_reference(
        dataclasses.asdict(j_config.polish_preset())) == polish_preset()
    over = dict(window_size=200, window_overlap=20, max_msa=40)
    assert from_reference(dataclasses.asdict(
        j_config.polish_preset(**over))) == polish_preset(**over)


def test_main_polish_fasta_bytes_match_jax(draft):
    tmp, reads_fa, asm_fa = draft
    common = ["--contigs", str(asm_fa), "--reads", str(reads_fa)] + SMALL
    j_out, t_out = tmp / "jax.fasta", tmp / "torch.fasta"
    assert j_cli.main_polish(common + ["--out", str(j_out)]) == 0
    assert t_cli.main_polish(
        common + ["--out", str(t_out), "--device", "cpu"]) == 0
    want, got = j_out.read_bytes(), t_out.read_bytes()
    assert want.startswith(b">contig1\n") and len(want) > 1900
    assert want == got


def _polish_piles(mz, index_cls, reads_fa, asm_fa):
    contigs = index_cls.from_file(str(asm_fa))
    reads = index_cls.from_file(str(reads_fa))
    merged = index_cls()
    for idx in (contigs, reads):
        for n in idx.names():
            merged.add(n, idx[n])
    piles = list(mz.map_to_targets_piles(
        [(n, contigs[n]) for n in contigs.names()],
        [(n, reads[n]) for n in reads.names()],
        mz.OverlapParams(), 20000))
    return piles, merged


@pytest.mark.parametrize("python_dbg", [False, True],
                         ids=["native_steps", "python_dbg"])
def test_host_fallback_matches_jax(draft, monkeypatch, python_dbg):
    """The fused native post calls report a capacity failure on both
    sides, so every window takes the step-by-step chain (and, with
    python_dbg, the Python DBG repair of core/dbg.py): the bytes must
    equal the JAX package's fallback and the port's fused path."""
    tmp, reads_fa, asm_fa = draft
    kw = dict(window_size=200, window_overlap=20, n_workers=2)
    t_cfg = polish_preset(**kw)
    t_piles, t_index = _polish_piles(t_mz, TReadIndex, reads_fa, asm_fa)
    fused = list(t_engine.process_piles(iter(t_piles), t_index, t_cfg,
                                        device="cpu"))

    def none(*a, **k):
        return None

    for mod in (j_native, t_native):
        monkeypatch.setattr(mod, "host_post_batch_native", none)
        monkeypatch.setattr(mod, "host_post_window_native", none)
        if python_dbg:
            monkeypatch.setattr(mod, "polish_correction_native", none)
    repairs = []
    real_dbg = t_engine.dbg_mod.polish_correction

    def python_repair(*a, **k):
        repairs.append(1)
        return real_dbg(*a, **k)

    monkeypatch.setattr(t_engine.dbg_mod, "polish_correction",
                        python_repair)
    j_piles, j_index = _polish_piles(j_mz, ReadIndex, reads_fa, asm_fa)
    want = list(j_engine.process_piles(iter(j_piles), j_index,
                                       j_config.polish_preset(**kw)))
    got = list(t_engine.process_piles(iter(t_piles), t_index, t_cfg,
                                      device="cpu"))
    assert bool(repairs) == python_dbg
    assert len(want) == len(got) == len(fused) == 1
    for (n1, c1, s1), (n2, c2, s2), (n3, c3, s3) in zip(want, got, fused):
        assert n1 == n2 == n3 == "contig1"
        assert len(c1) > 1900
        assert np.array_equal(c1, c2) and np.array_equal(s1, s2)
        assert np.array_equal(c2, c3) and np.array_equal(s2, s3)


def test_kmer_host_helpers_match_jax_and_native():
    """ops/kmer.py's host helpers against the JAX package's and against
    the native wrappers of the fallback chain, on one window's pile."""
    rng = np.random.default_rng(5)
    k = 9
    tpl = rng.integers(0, 4, 300).astype(np.uint8)
    frags = [tpl]
    for _ in range(12):
        f, _ = simulate.mutate(tpl[rng.integers(0, 40):], rng, 0.08)
        frags.append(f.astype(np.uint8))
    frags.append(tpl[:5])                       # shorter than k
    dense = t_kmer.count_kmers_host(frags, k)
    assert np.array_equal(dense, j_kmer.count_kmers_host(frags, k))
    n_dense, keys = t_native.count_kmers_sparse_native(frags, k)
    assert np.array_equal(n_dense, dense)
    assert np.array_equal(keys, np.flatnonzero(dense))
    for support in (1, 4, 8):
        want = j_kmer.count_anchors_host(frags, k, support)
        assert t_kmer.count_anchors_host(frags, k, support) == want
        assert t_native.count_anchors_native(frags, k, support) == want
    assert want > 0
    cons = frags[3]
    mask = t_kmer.solidity_mask(cons, dense, k, 4)
    assert np.array_equal(mask, j_kmer.solidity_mask(cons, dense, k, 4))
    assert 0 < mask.sum() < len(cons)
    got = t_native.polish_correction_native(cons, mask, dense, k, 4)
    assert got is not None
    want = j_native.polish_correction_native(cons, mask, dense, k, 4)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_deep_pile_bucket_wire_bytes_match_jax():
    """The polish preset's deepest fragment bucket (S = 152: maxMSA 150
    plus the template) through one consensus call with both refinement
    rounds, the warm round on its top 38 slots: the port's wire bytes
    equal the JAX package's.  Short rows keep the plain aligner quick."""
    rng = np.random.default_rng(152)
    B, S, Lf, W = 2, 152, 128, 128
    frags = np.zeros((B, S, Lf), np.uint8)
    frag_len = np.zeros((B, S), np.int32)
    tpl = np.zeros((B, W), np.uint8)
    tpl_len = np.zeros(B, np.int32)
    d0 = rng.integers(-4, 5, (B, S)).astype(np.int32)
    for b, depth in enumerate((S, 97)):
        truth = rng.integers(0, 4, 100).astype(np.uint8)
        for s in range(depth):
            f, _ = simulate.mutate(truth, rng, 0.12)
            frags[b, s, : min(len(f), Lf)] = f[:Lf]
            frag_len[b, s] = min(len(f), Lf)
        tpl[b, : frag_len[b, 0]] = frags[b, 0, : frag_len[b, 0]]
        tpl_len[b] = frag_len[b, 0]
    buf = t_cons.wire_encode_inputs(
        t_cons.pack_bases_host(frags), frag_len, tpl, tpl_len, d0)
    kw = dict(S=S, Pb=Lf // 4, Lt=W, min_column_support=1, rounds=2,
              warm_frac=0.25, assemble_out=True)
    sc = dict(max_hgap=16, band=128)
    want = np.asarray(j_cons.consensus_votes_wire(
        jnp.asarray(buf), scoring=j_align.Scoring(**sc), **kw))
    got = t_cons.consensus_votes_wire(
        torch.from_numpy(buf), scoring=t_align.Scoring(**sc), **kw).numpy()
    assert want.dtype == got.dtype and np.array_equal(want, got)
    cons = t_cons.wire_decode_cons(got, W)
    assert all(len(c) > 80 for c in cons)
