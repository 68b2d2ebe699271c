"""The port's consensus helpers, native wrappers and kernel routing on
the CPU against the JAX package's.

Inputs come from numpy seeds; every output is an integer or a byte, so
the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consent_tpu import native as j_native
from consent_tpu.ops import align as j_align
from consent_tpu.ops import consensus as j_cons
from consent_tpu.ops import kmer as j_kmer
from consent_tpu_torch import native as t_native
from consent_tpu_torch.ops import align as t_align
from consent_tpu_torch.ops import consensus as t_cons
from consent_tpu_torch.ops import cuda_align

torch.set_num_threads(2)

SC = dict(max_hgap=16, band=128)


def _random_vote_inputs(seed, B=6, S=8, Lf=128, W=128):
    """tests/test_consensus.py's generator."""
    rng = np.random.default_rng(seed)
    frags = rng.integers(0, 4, (B, S, Lf)).astype(np.uint8)
    frag_len = rng.integers(Lf // 2, Lf + 1, (B, S)).astype(np.int32)
    tpl = rng.integers(0, 4, (B, W)).astype(np.uint8)
    tpl_len = rng.integers(W // 2, W + 1, B).astype(np.int32)
    d0 = rng.integers(-4, 5, (B, S)).astype(np.int32)
    return frags, frag_len, tpl, tpl_len, d0


def _noisy_inputs(seed, B=4, S=8, Lf=128, W=128):
    """Noisy copies of one truth per window, the template one of them."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, (B, W)).astype(np.uint8)
    frags = np.zeros((B, S, Lf), np.uint8)
    frag_len = np.zeros((B, S), np.int32)
    for b in range(B):
        for s in range(int(rng.integers(2, S + 1))):
            keep = rng.random(W) > 0.08
            f = truth[b, keep]
            flip = rng.random(len(f)) < 0.05
            f[flip] = (f[flip] + 1) % 4
            frags[b, s, : len(f)] = f[:Lf]
            frag_len[b, s] = min(len(f), Lf)
    tpl = np.zeros((B, W), np.uint8)
    tpl_len = frag_len[:, 0].copy()
    tpl[:, :Lf] = frags[:, 0]
    d0 = rng.integers(-4, 5, (B, S)).astype(np.int32)
    return frags, frag_len, tpl, tpl_len, d0


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("gen", [_random_vote_inputs, _noisy_inputs])
def test_wire_format_roundtrip_matches_unpacked(gen):
    """tests/test_consensus.py's wire round trip: the port's wire votes,
    decoded and host-assembled, equal its consensus_votes assembled, and
    the JAX package's on the same inputs."""
    frags, frag_len, tpl, tpl_len, d0 = gen(3)
    S, Lf, W = frags.shape[1], frags.shape[2], tpl.shape[1]
    tv = t_cons.consensus_votes(*_t(frags, frag_len, tpl, tpl_len), S=S,
                                min_column_support=2,
                                scoring=t_align.Scoring(**SC),
                                frag_d0=_t(d0)[0])
    ref = t_cons.assemble_consensus_batch(tv, tpl_len.tolist())
    jv = j_cons.consensus_votes(
        *map(jnp.asarray, (frags, frag_len, tpl, tpl_len)), S=S,
        min_column_support=2, scoring=j_align.Scoring(**SC),
        frag_d0=jnp.asarray(d0))
    jref = j_cons.assemble_consensus_batch(jax.tree.map(np.asarray, jv),
                                           tpl_len.tolist())
    buf = t_cons.wire_encode_inputs(t_cons.pack_bases_host(frags), frag_len,
                                    tpl, tpl_len, d0)
    out = t_cons.consensus_votes_wire(_t(buf)[0], S=S, Pb=Lf // 4, Lt=W,
                                      min_column_support=2,
                                      scoring=t_align.Scoring(**SC))
    votes, w_len = t_cons.wire_decode_votes(out.numpy(), W)
    jvotes, jw_len = j_cons.wire_decode_votes(out.numpy(), W)
    assert np.array_equal(w_len, tpl_len)
    assert all(np.array_equal(a, b) for a, b in zip(votes, jvotes))
    wire = t_cons.assemble_consensus_batch(votes, w_len.tolist())
    assert len(ref) == len(wire) == len(jref)
    for a, b, c in zip(ref, wire, jref):
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("rounds", [1, 2])
def test_assemble_out_equals_host_assembly(rounds):
    """tests/test_consensus.py's fused-assembly check: the assembled
    wire output equals host-assembling the votes wire and truncating to
    Lt."""
    frags, frag_len, tpl, tpl_len, d0 = _random_vote_inputs(31 + rounds)
    B, W = tpl.shape
    S = frags.shape[1]
    buf = t_cons.wire_encode_inputs(t_cons.pack_bases_host(frags), frag_len,
                                    tpl, tpl_len, d0)
    kw = dict(S=S, Pb=frags.shape[2] // 4, Lt=W, min_column_support=2,
              scoring=t_align.Scoring(**SC), rounds=rounds)
    votes, w_len = t_cons.wire_decode_votes(
        t_cons.consensus_votes_wire(_t(buf)[0], **kw).numpy(), W)
    want = [c[:W] for c in t_cons.assemble_consensus_batch(
        votes, w_len.tolist())]
    got = t_cons.wire_decode_cons(t_cons.consensus_votes_wire(
        _t(buf)[0], assemble_out=True, **kw).numpy(), W)
    assert len(got) == len(want) == B
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_packed_votes_match_jax():
    """pack_votes / consensus_votes_packed / unpack_votes_host and the
    one-window assemble_consensus against the JAX package's."""
    frags, frag_len, tpl, tpl_len, d0 = _noisy_inputs(7)
    S = frags.shape[1]
    pk = t_cons.pack_bases_host(frags)
    got = t_cons.consensus_votes_packed(
        *_t(pk, frag_len, tpl, tpl_len), S=S, min_column_support=2,
        scoring=t_align.Scoring(**SC), frag_d0=_t(d0)[0], frags_packed=True)
    want = j_cons.consensus_votes_packed(
        *map(jnp.asarray, (pk, frag_len, tpl, tpl_len)), S=S,
        min_column_support=2, scoring=j_align.Scoring(**SC),
        frag_d0=jnp.asarray(d0), frags_packed=True)
    for field in want._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    tu = t_cons.unpack_votes_host(got)
    ju = j_cons.unpack_votes_host(want)
    for a, b in zip(tu, ju):
        assert (a is None and b is None) or np.array_equal(a, b)
    tv = t_cons.consensus_votes(*_t(frags, frag_len, tpl, tpl_len), S=S,
                                min_column_support=2,
                                scoring=t_align.Scoring(**SC),
                                frag_d0=_t(d0)[0])
    jv = jax.tree.map(np.asarray, j_cons.consensus_votes(
        *map(jnp.asarray, (frags, frag_len, tpl, tpl_len)), S=S,
        min_column_support=2, scoring=j_align.Scoring(**SC),
        frag_d0=jnp.asarray(d0)))
    batch = t_cons.assemble_consensus_batch(got, tpl_len.tolist())
    for b in range(len(tpl)):
        one = t_cons.assemble_consensus(tv, b, int(tpl_len[b]))
        assert np.array_equal(one, batch[b])
        assert np.array_equal(one, j_cons.assemble_consensus(
            jv, b, int(tpl_len[b])))


def test_partials_of_slot_shards_add_up():
    """Phase A over two halves of the slots, summed, equals phase A over
    all slots; phase B of the sum is consensus_votes (an all-empty half
    adds zeros)."""
    frags, frag_len, tpl, tpl_len, d0 = _t(*_noisy_inputs(11))
    frag_len[1, 4:] = 0
    S = frags.shape[1]
    sc = t_align.Scoring(**SC)
    whole = t_cons.consensus_partials(frags, frag_len, tpl, tpl_len, S=S,
                                      scoring=sc, frag_d0=d0)
    halves = [t_cons.consensus_partials(
        frags[:, h:h + S // 2], frag_len[:, h:h + S // 2], tpl, tpl_len,
        S=S // 2, scoring=sc, frag_d0=d0[:, h:h + S // 2])
        for h in (0, S // 2)]
    total = t_cons.sum_partials(halves)
    for field, a, b in zip(whole._fields, whole, total):
        assert a.dtype == b.dtype and torch.equal(a, b), field
    assert whole.votes_base.dtype == torch.int16
    assert whole.pre_valid.dtype == torch.int32
    assert not halves[1].coverage[1].any()
    v = t_cons.consensus_from_partials(total, tpl, tpl_len,
                                       min_column_support=2)
    w = t_cons.consensus_votes(frags, frag_len, tpl, tpl_len, S=S,
                               min_column_support=2, scoring=sc, frag_d0=d0)
    for a, b in zip(v, w):
        assert torch.equal(a, b)


def test_count_kmers_native_matches_host():
    """tests/test_native.py's k-mer count: the port's native wrapper
    equals the JAX package's host count and its native wrapper."""
    rng = np.random.default_rng(0)
    frags = [rng.integers(0, 4, rng.integers(3, 60)).astype(np.uint8)
             for _ in range(12)]
    k = 5
    got = t_native.count_kmers_native(frags, k)
    assert np.array_equal(got, j_kmer.count_kmers_host(frags, k))
    assert np.array_equal(got, j_native.count_kmers_native(frags, k))
    assert np.array_equal(t_native.count_kmers_native([], k),
                          np.zeros(4 ** k, np.int32))


def test_assemble_windows_native_matches_python():
    """tests/test_native.py's batch assembly: the native path equals the
    unpacked Python assembly, in both packages."""
    rng = np.random.default_rng(3)
    B, W, K = 17, 256, t_cons.INS_CAP
    p = t_cons.PackedVotes(
        col_base=rng.integers(0, 4, (B, W)).astype(np.int8),
        col_del=(rng.random((B, W)) < 0.1).astype(np.int8),
        ins_len=rng.integers(0, K + 1, (B, W)).astype(np.uint8)
        * (rng.random((B, W)) < 0.15),
        ins_pack=rng.integers(-(2 ** 31), 2 ** 31 - 1, (B, W)).astype(
            np.int64).astype(np.int32),
        pre_len=rng.integers(0, K + 1, B).astype(np.int32),
        pre_pack=rng.integers(0, 2 ** 31 - 1, B).astype(np.int32),
        suf_len=rng.integers(0, K + 1, B).astype(np.int32),
        suf_pack=rng.integers(0, 2 ** 31 - 1, B).astype(np.int32),
    )
    w_lens = rng.integers(1, W + 1, B).tolist()
    got = t_native.assemble_windows_native(*p, w_lens)
    want = t_cons.assemble_consensus_batch(t_cons.unpack_votes_host(p),
                                           w_lens)
    jp = j_cons.PackedVotes(*p)
    jwant = j_cons.assemble_consensus_batch(j_cons.unpack_votes_host(jp),
                                            w_lens)
    assert len(got) == len(want) == len(jwant) == B
    for g, w, j in zip(got, want, jwant):
        assert np.array_equal(g, w) and np.array_equal(g, j)
    fast = t_cons.assemble_consensus_batch(p, w_lens)
    assert all(np.array_equal(a, b) for a, b in zip(fast, got))


def test_variant_routing_by_shape():
    """Each wrapper's design, picked by shape: the banded kernel takes 32,
    64 or a multiple of 128 up to W (one warp per lane to 1,024, the
    tiled design above); the full-width kernel runs one warp per lane for
    exact gaps to 1,024 columns, one block per lane to 16,384, the tiled
    design above."""
    bv = cuda_align.banded_variant
    for band in (32, 64, 128, 384, 1024):
        assert bv(band, 1280) == "warp"
    for band in (1152, 1280, 4096):
        assert bv(band, 4096) == "tiled"
    for band, W in ((96, 640), (1100, 1280), (1152, 1024), (0, 640),
                    (16, 640), (2048, 1280)):
        with pytest.raises(ValueError):
            bv(band, W)
    fv = cuda_align.full_variant
    stitch = t_align.Scoring(2, -2, 3, 1)
    capped = t_align.Scoring(2, -4, 4, 2, max_hgap=16)
    assert fv(640, stitch) == fv(1024, stitch) == "warp"
    assert fv(640, capped) == fv(1025, stitch) == "block"
    assert fv(16384, stitch) == "block"
    assert fv(16385, stitch) == fv(16512, capped) == "tiled"
    assert fv(640, t_align.Scoring(2, -2, 3, 13)) == "block"
    with pytest.raises(ValueError):
        fv(0, stitch)


def test_lane_chunks_alone_over_budget():
    """A lane whose scratch exceeds HM_BUDGET_BYTES runs in a chunk of
    its own; it raises, naming the card's memory, only where the card
    cannot hold that one lane."""
    budget = cuda_align.HM_BUDGET_BYTES
    per = cuda_align.full_hm_lane_bytes(70000, 16384)
    assert per > budget
    assert cuda_align.full_lane_chunks(3, 70000, 16384) == \
        [(0, 1), (1, 2), (2, 3)]
    assert cuda_align.full_lane_chunks(2, 70000, 16384,
                                       free_bytes=per) == [(0, 1), (1, 2)]
    with pytest.raises(ValueError, match="H100 .80 GB"):
        cuda_align.full_lane_chunks(1, 70000, 16384, free_bytes=per - 1,
                                    card="H100 (80 GB)")
    tiled = cuda_align.tiled_lane_bytes(16512, 16512)
    assert cuda_align.full_hm_lane_bytes(16512, 16512) == tiled
    assert tiled == 16512 * 16512 * 2 + 16 * 16512
    assert cuda_align.full_lane_chunks(2, 16512, 16512) == [(0, 2)]
    chunks = cuda_align.lane_chunks(256, cuda_align.tiled_lane_bytes(
        512, 1280))
    assert chunks == [(0, 256)]


def test_plain_banded_at_band_1152_matches_jax():
    """The plain banded aligner at band 1,152 (W = 1,280, N = 4), the
    tiled design's oracle, equals the JAX package's reference."""
    rng = np.random.default_rng(12)
    N, Lq, W = 4, 160, 1280
    r = rng.integers(0, 4, (N, W)).astype(np.uint8)
    d0 = np.array([0, 300, -20, 1100], np.int32)
    q = np.zeros((N, Lq), np.uint8)
    for n in range(N):
        src = np.clip(np.arange(Lq) + d0[n], 0, W - 1)
        q[n] = r[n, src]
        flip = rng.random(Lq) < 0.1
        q[n, flip] = (q[n, flip] + 1) % 4
    q_len = np.array([Lq, 120, 0, 90], np.int32)
    r_len = np.array([W, W - 100, W, 1200], np.int32)
    for gap in (16, 0):
        kw = dict(match=2, mismatch=-4, gap_open=4, gap_extend=2,
                  max_hgap=gap, band=1152)
        want = j_align.posterior_summary(
            *map(jnp.asarray, (q, q_len, r, r_len)), j_align.Scoring(**kw),
            d0=jnp.asarray(d0))
        got = t_align.posterior_summary(*_t(q, q_len, r, r_len),
                                        t_align.Scoring(**kw),
                                        d0=_t(d0)[0])
        for field in want._fields:
            a, b = np.asarray(getattr(want, field)), getattr(got, field)
            assert np.array_equal(a, b.numpy()), (gap, field)
        assert got.matched[0].any() and got.matched[3].any()
