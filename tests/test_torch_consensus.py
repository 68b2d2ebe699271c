"""The port's consensus ops against the JAX package's, byte for byte.

Same seeded numpy inputs go through consent_tpu.ops.consensus (XLA on
the CPU) and consent_tpu_torch.ops.consensus (the plain PyTorch
aligner on the CPU); the wire outputs must be identical bytes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consent_tpu.ops import align as j_align
from consent_tpu.ops import consensus as j_cons
from consent_tpu_torch.ops import align as t_align
from consent_tpu_torch.ops import consensus as t_cons

torch.set_num_threads(2)

SC = dict(max_hgap=16, band=128)


def _noisy(rng, truth, rate):
    out = []
    for b in truth:
        p = rng.random()
        if p < rate / 3:
            continue
        if p < 2 * rate / 3:
            out.append(int(rng.integers(0, 4)))
        elif p < rate:
            out.extend([int(b), int(rng.integers(0, 4))])
        else:
            out.append(int(b))
    return np.array(out, np.uint8)


def vote_inputs(seed, kind, B=4, S=8, Lf=128, W=128):
    """kind 'noisy': noisy copies of one truth per window, the template
    one of them (the engine's shape of data), homopolymer runs included;
    kind 'random': unrelated random codes (tie-heavy votes)."""
    rng = np.random.default_rng(seed)
    frags = np.zeros((B, S, Lf), np.uint8)
    frag_len = np.zeros((B, S), np.int32)
    tpl = np.zeros((B, W), np.uint8)
    tpl_len = np.zeros(B, np.int32)
    d0 = rng.integers(-4, 5, (B, S)).astype(np.int32)
    for b in range(B):
        if kind == "random":
            frags[b] = rng.integers(0, 4, (S, Lf))
            frag_len[b] = rng.integers(Lf // 2, Lf + 1, S)
            tpl[b] = rng.integers(0, 4, W)
            tpl_len[b] = rng.integers(W // 2, W + 1)
            continue
        truth = np.repeat(rng.integers(0, 4, 70), rng.integers(1, 4, 70))
        truth = truth[:100].astype(np.uint8)
        n_frag = int(rng.integers(2, S + 1))
        for s in range(n_frag):
            f = _noisy(rng, truth, 0.12)[:Lf]
            frags[b, s, : len(f)] = f
            frag_len[b, s] = len(f)
        t = frags[b, 0, : frag_len[b, 0]][:W]
        tpl[b, : len(t)] = t
        tpl_len[b] = len(t)
    return frags, frag_len, tpl, tpl_len, d0


def tie_inputs():
    """Two windows whose columns split 2:2 between bases and between a
    base and a deletion (argmax ties: consensus.py:205,224,828)."""
    S, Lf, W = 4, 128, 128
    base = np.array([0, 1, 2, 3, 0, 2, 1, 3] * 6, np.uint8)
    frags = np.zeros((2, S, Lf), np.uint8)
    frag_len = np.zeros((2, S), np.int32)
    sub = base.copy()
    sub[20] = (sub[20] + 1) % 4
    dele = np.delete(base, 30)
    ins = np.insert(base, 12, [3, 3])
    for s, f in enumerate([base, base, sub, sub]):
        frags[0, s, : len(f)] = f
        frag_len[0, s] = len(f)
    for s, f in enumerate([base, ins, dele, dele]):
        frags[1, s, : len(f)] = f
        frag_len[1, s] = len(f)
    tpl = np.zeros((2, W), np.uint8)
    tpl[:, : len(base)] = base
    tpl_len = np.full(2, len(base), np.int32)
    d0 = np.zeros((2, S), np.int32)
    return frags, frag_len, tpl, tpl_len, d0


CASES = {
    "noisy": lambda: vote_inputs(5, "noisy"),
    "random": lambda: vote_inputs(6, "random"),
    "ties": tie_inputs,
}


def both_wire(inputs, **kw):
    frags, frag_len, tpl, tpl_len, d0 = inputs
    S, Lf = frags.shape[1:]
    Lt = tpl.shape[1]
    j_buf = j_cons.wire_encode_inputs(
        j_cons.pack_bases_host(frags), frag_len, tpl, tpl_len, d0)
    t_buf = t_cons.wire_encode_inputs(
        t_cons.pack_bases_host(frags), frag_len, tpl, tpl_len, d0)
    assert np.array_equal(j_buf, t_buf)
    want = np.asarray(j_cons.consensus_votes_wire(
        jnp.asarray(j_buf), S=S, Pb=Lf // 4, Lt=Lt, min_column_support=2,
        scoring=j_align.Scoring(**SC), **kw))
    got = t_cons.consensus_votes_wire(
        torch.from_numpy(t_buf), S=S, Pb=Lf // 4, Lt=Lt,
        min_column_support=2, scoring=t_align.Scoring(**SC), **kw).numpy()
    return want, got


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds,warm_frac", [(1, 1.0), (2, 1.0), (2, 0.25)])
@pytest.mark.parametrize("assemble_out", [False, True])
def test_wire_bytes_equal(case, rounds, warm_frac, assemble_out):
    want, got = both_wire(CASES[case](), rounds=rounds, warm_frac=warm_frac,
                          assemble_out=assemble_out)
    assert want.dtype == got.dtype and want.shape == got.shape
    assert np.array_equal(want, got)
    if assemble_out:
        Lt = CASES[case]()[2].shape[1]
        w = j_cons.wire_decode_cons(want, Lt)
        g = t_cons.wire_decode_cons(got, Lt)
        assert all(np.array_equal(a, b) for a, b in zip(w, g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_votes_and_template_assembly_equal(case):
    frags, frag_len, tpl, tpl_len, d0 = CASES[case]()
    S = frags.shape[1]
    Lt = tpl.shape[1]
    jv = j_cons.consensus_votes(
        jnp.asarray(frags), jnp.asarray(frag_len), jnp.asarray(tpl),
        jnp.asarray(tpl_len), S=S, min_column_support=2,
        scoring=j_align.Scoring(**SC), frag_d0=jnp.asarray(d0))
    tv = t_cons.consensus_votes(
        torch.from_numpy(frags), torch.from_numpy(frag_len),
        torch.from_numpy(tpl), torch.from_numpy(tpl_len), S=S,
        min_column_support=2, scoring=t_align.Scoring(**SC),
        frag_d0=torch.from_numpy(d0))
    for field in jv._fields:
        a, b = np.asarray(getattr(jv, field)), getattr(tv, field).numpy()
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    jt, jl = j_cons.assemble_template_device(jv, jnp.asarray(tpl_len), Lt)
    tt, tl = t_cons.assemble_template_device(tv, torch.from_numpy(tpl_len), Lt)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())


def test_host_helpers_equal():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, (3, 5, 64)).astype(np.uint8)
    packed = t_cons.pack_bases_host(codes)
    assert np.array_equal(packed, j_cons.pack_bases_host(codes))
    assert np.array_equal(
        t_cons.unpack_bases(torch.from_numpy(packed), 64).numpy(), codes)
    assert np.array_equal(
        t_cons.pack_bases_device(torch.from_numpy(codes)).numpy(), packed)
    frags, frag_len, tpl, tpl_len, d0 = vote_inputs(3, "noisy")
    pk = t_cons.pack_bases_host(frags)
    assert np.array_equal(
        t_cons.wire_encode_inputs(pk, frag_len, tpl, tpl_len, d0),
        j_cons.wire_encode_inputs(pk, frag_len, tpl, tpl_len, d0))
    Lt = 128
    arr = rng.integers(0, 256, (4, Lt // 4 + 4)).astype(np.uint8)
    arr[:, Lt // 4 :] = np.array([100, 0, 0, 0], np.uint8)
    for a, b in zip(t_cons.wire_decode_cons(arr, Lt),
                    j_cons.wire_decode_cons(arr, Lt)):
        assert np.array_equal(a, b)
