"""The port's plain posterior aligner against the JAX package's, bit
for bit: the XLA-scan reference for every band / gap-cap setting, and
the Pallas kernels in interpret mode on one small case each."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consent_tpu.ops import align as j_align
from consent_tpu.ops import pallas_align
from consent_tpu_torch.ops import align as t_align
from consent_tpu_torch.ops import cuda_align

torch.set_num_threads(2)


def pad_to(x, L):
    out = np.zeros(L, dtype=np.uint8)
    out[: len(x)] = x
    return out


def random_pair(rng, n=40, mut=0.15):
    """tests/test_pallas_align.py's generator: a random truth and a
    mutated copy."""
    true = rng.integers(0, 4, n).astype(np.uint8)
    q = []
    for bse in true:
        p = rng.random()
        if p < mut / 3:
            continue
        elif p < 2 * mut / 3:
            q.append(rng.integers(0, 4))
        elif p < mut:
            q.extend([bse, rng.integers(0, 4)])
        else:
            q.append(bse)
    return np.array(q, dtype=np.uint8), true


def near_diagonal(rng, Lq, Lr, n=5):
    """tests/test_pallas_align.py's banded cases: fragments at offsets
    d0 in [-40, 100) with ragged lengths, plus empty and degenerate
    lanes (empty query, one-base query, offset past the template)."""
    qs, rs, d0s = [], [], []
    for _ in range(n):
        ref = rng.integers(0, 4, Lr).astype(np.uint8)
        d0 = int(rng.integers(-40, 100))
        L = int(rng.integers(30, Lq))
        src = np.clip(np.arange(L) + d0, 0, Lr - 1)
        frag = ref[src].copy()
        pos = rng.integers(0, L, max(1, L // 8))
        frag[pos] = (frag[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
        qs.append(frag)
        rs.append(ref[: int(rng.integers(Lr // 2, Lr + 1))])
        d0s.append(d0)
    qs += [np.empty(0, np.uint8), np.array([2], np.uint8),
           np.array([1, 2, 3, 0, 1, 2, 3, 1, 2], np.uint8)]
    rs += [np.array([0, 1], np.uint8), np.array([2, 2, 2], np.uint8),
           np.array([2, 2], np.uint8)]
    d0s += [0, -3, Lr + 40]
    return qs, rs, d0s


def arrays(qs, rs, d0s, Lq, Lr):
    q = np.array([pad_to(x, Lq) for x in qs])
    ql = np.array([len(x) for x in qs], np.int32)
    r = np.array([pad_to(x, Lr) for x in rs])
    rl = np.array([len(x) for x in rs], np.int32)
    return q, ql, r, rl, np.array(d0s, np.int32)


def run_torch(q, ql, r, rl, d0, sc):
    t = [torch.from_numpy(x) for x in (q, ql, r, rl, d0)]
    return cuda_align.posterior_summary(
        *t[:4], t_align.Scoring(*sc), d0=t[4] if sc.band else None)


def assert_equal(a, b):
    for field in a._fields:
        x, y = np.asarray(getattr(a, field)), getattr(b, field).numpy()
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("max_hgap", [0, 16])
@pytest.mark.parametrize("band", [0, 32, 64, 128, 256])
def test_posterior_summary_matches_jax(band, max_hgap, seed):
    rng = np.random.default_rng(seed)
    Lq, Lr = 192, 256
    qs, rs, d0s = near_diagonal(rng, Lq, Lr)
    for _ in range(3):
        a, b = random_pair(rng, n=int(rng.integers(20, 100)))
        qs.append(a)
        rs.append(b)
        d0s.append(0)
    q, ql, r, rl, d0 = arrays(qs, rs, d0s, Lq, Lr)
    sc = j_align.Scoring(max_hgap=max_hgap, band=band)
    want = j_align.posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl),
        sc, d0=jnp.asarray(d0) if band else None)
    got = run_torch(q, ql, r, rl, d0, sc)
    assert_equal(want, got)
    ws, gs = j_align.summary_spans(want), t_align.summary_spans(got)
    assert_equal(ws, gs)


@pytest.mark.parametrize("max_hgap", [0, 16])
@pytest.mark.parametrize("band", [0, 128, 256])
def test_posterior_ignores_bases_past_query_end(band, max_hgap):
    """Both kernels (banded, and full width at band 0) sweep each lane's
    rows only up to its q_len and never read the bases at or past it:
    random bases there leave the plain version's six outputs unchanged,
    and those outputs still equal the JAX package's on the same inputs."""
    rng = np.random.default_rng(band + max_hgap)
    Lq, Lr = 192, 320
    qs, rs, d0s = near_diagonal(rng, Lq, Lr, n=6)
    qs.append(rng.integers(0, 4, Lq).astype(np.uint8))     # q_len = Lq
    rs.append(rng.integers(0, 4, Lr).astype(np.uint8))
    d0s.append(5)
    q, ql, r, rl, d0 = arrays(qs, rs, d0s, Lq, Lr)
    sc = j_align.Scoring(max_hgap=max_hgap, band=band)
    clean = run_torch(q, ql, r, rl, d0, sc)
    tail = np.arange(Lq)[None, :] >= ql[:, None]
    assert tail.any(axis=1).sum() >= 6
    q[tail] = rng.integers(0, 4, int(tail.sum()))
    noisy = run_torch(q, ql, r, rl, d0, sc)
    for field in clean._fields:
        assert torch.equal(getattr(clean, field), getattr(noisy, field)), \
            field
    want = j_align.posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl),
        sc, d0=jnp.asarray(d0) if band else None)
    assert_equal(want, noisy)
    assert noisy.matched.any(dim=1).sum() >= 6


@pytest.mark.parametrize("max_hgap", [0, 16])
def test_full_width_padding_lanes_give_empty_summary(max_hgap):
    """The stitch pads each device call to a power of two with lanes of
    q_len = r_len = 0; lanes with an empty query, an empty template or
    both give the empty summary (opt 0, nothing matched, i_first Lq,
    i_last -1, base and ins_pack 0), beside live lanes, and equal the
    JAX package's output."""
    rng = np.random.default_rng(11 + max_hgap)
    Lq, Lr = 160, 256
    pairs = [random_pair(rng, n=int(rng.integers(40, 120)))
             for _ in range(4)]
    qs = [p[0] for p in pairs]
    rs = [p[1] for p in pairs]
    empty_q = np.empty(0, np.uint8)
    qs += [empty_q, rng.integers(0, 4, 50).astype(np.uint8), empty_q,
           empty_q]
    rs += [rng.integers(0, 4, 90).astype(np.uint8), np.empty(0, np.uint8),
           np.empty(0, np.uint8), np.empty(0, np.uint8)]
    q, ql, r, rl, d0 = arrays(qs, rs, [0] * len(qs), Lq, Lr)
    # padding lanes carry whatever the buffer held past their lengths
    q[4:] = rng.integers(0, 4, q[4:].shape)
    r[5:] = rng.integers(0, 4, r[5:].shape)
    sc = j_align.Scoring(2, -2, 3, 1, max_hgap=max_hgap)
    got = run_torch(q, ql, r, rl, d0, sc)
    empty = slice(4, None)
    assert (got.opt[empty] == 0).all()
    assert not got.matched[empty].any()
    assert (got.i_first[empty] == Lq).all()
    assert (got.i_last[empty] == -1).all()
    assert (got.base[empty] == 0).all()
    assert (got.ins_pack[empty] == 0).all()
    assert got.matched[:4].any(dim=1).all()
    want = j_align.posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl), sc)
    assert_equal(want, got)


def test_full_stage_cols_cover_the_warp_kernel():
    """The wrapper's hm scratch rows are as wide as the full-width
    kernel's staged rows: W rounded up to 128 columns, i.e. 32 threads x
    C columns with C a multiple of 4 up to 1,024 columns."""
    for W in (1, 31, 128, 129, 640, 700, 768, 896, 1000, 1024, 1152, 4096):
        cols = cuda_align.full_stage_cols(W)
        assert cols >= W and cols % 128 == 0 and cols - W < 128
        if W <= 1024:
            assert (cols // 32) % 4 == 0 and cols // 32 <= 32


def test_stitch_scoring_matches_jax():
    """The stitch aligner's scoring (2/-2/3/1, exact gaps) at full
    width, on random_pair lanes and lane counts that are not powers of
    two."""
    rng = np.random.default_rng(7)
    pairs = [random_pair(rng, n=int(rng.integers(20, 120)))
             for _ in range(3)]
    q, ql, r, rl, d0 = arrays([p[0] for p in pairs], [p[1] for p in pairs],
                              [0, 0, 0], 160, 128)
    sc = j_align.Scoring(2, -2, 3, 1)
    want = j_align.posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl), sc)
    assert_equal(want, run_torch(q, ql, r, rl, d0, sc))


def test_full_width_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    pairs = [random_pair(rng, n=int(rng.integers(20, 100))) for _ in range(4)]
    q, ql, r, rl, d0 = arrays([p[0] for p in pairs], [p[1] for p in pairs],
                              [0] * 4, 160, 128)
    sc = j_align.Scoring()
    want = pallas_align.pallas_posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl), sc,
        interpret=True, tile_lanes=8)
    assert_equal(want, run_torch(q, ql, r, rl, d0, sc))


def test_banded_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    q, ql, r, rl, d0 = arrays(*near_diagonal(rng, 128, 256, n=3), 128, 256)
    sc = j_align.Scoring(max_hgap=16, band=128)
    want = pallas_align.pallas_banded_posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl),
        jnp.asarray(d0), sc, interpret=True, tile_lanes=8)
    assert_equal(want, run_torch(q, ql, r, rl, d0, sc))


def test_scan_window_matches_plain_doubling():
    """The kernels' horizontal-gap window equals what the plain
    version's doubling scan covers."""
    for width in (128, 640):
        for gap in (0, 1, 2, 3, 16, 17, 100, 128, 640, 1000):
            x = torch.full((1, width), -100, dtype=torch.int16)
            x[0, 0] = 0
            reach = int((t_align._prefix_max_exclusive(x, gap)[0] == 0)
                        .nonzero().max())
            window = cuda_align.scan_window(gap, width)
            assert 1 <= window <= width
            assert min(window, width - 1) == reach, (gap, width)


def test_lane_histogram_counts_launches_by_lane_count():
    """The wrappers count each kernel's launches by lane count beside
    the plain launch count; a reset clears both."""
    try:
        cuda_align.reset_launch_counts()
        for lanes in (256, 256, 64):
            cuda_align._count("full_posterior", lanes)
        cuda_align._count("banded_posterior", 4096)
        assert cuda_align.launch_counts() == {"banded_posterior": 1,
                                              "full_posterior": 3}
        assert cuda_align.lane_histogram() == {
            "banded_posterior": {4096: 1},
            "full_posterior": {64: 1, 256: 2}}
        cuda_align.reset_launch_counts()
        assert cuda_align.launch_counts() == {"banded_posterior": 0,
                                              "full_posterior": 0}
        assert cuda_align.lane_histogram() == {"banded_posterior": {},
                                               "full_posterior": {}}
    finally:
        cuda_align.reset_launch_counts()


@pytest.mark.parametrize("max_hgap", [0, 16])
@pytest.mark.parametrize("band", [384, 640])
def test_wide_bands_match_jax(band, max_hgap):
    """Bands that are multiples of 128 but not powers of two (12 and 20
    slots per thread of the banded kernel): the plain version at bands
    384 and 640 equals the JAX package's aligner, templates as wide as
    the band or wider."""
    rng = np.random.default_rng(band + max_hgap)
    Lq, Lr = 256, band + 128
    qs, rs, d0s = near_diagonal(rng, Lq, Lr, n=4)
    # a fragment far off the diagonal: only a wide band reaches it
    ref = rng.integers(0, 4, Lr).astype(np.uint8)
    qs.append(ref[band // 2 - 40: band // 2 + 160].copy())
    rs.append(ref)
    d0s.append(0)
    q, ql, r, rl, d0 = arrays(qs, rs, d0s, Lq, Lr)
    sc = j_align.Scoring(max_hgap=max_hgap, band=band)
    want = j_align.posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl),
        sc, d0=jnp.asarray(d0))
    got = run_torch(q, ql, r, rl, d0, sc)
    assert_equal(want, got)
    assert got.matched[-1].sum() > 100


def test_full_width_4224_matches_jax():
    """The stitch's template at --windowSize 4,084 (4,224 columns, the
    full-width kernel's one-block-per-lane path with 8 columns per
    thread): the plain version equals the JAX package's aligner, with
    fragments placed across the whole template."""
    rng = np.random.default_rng(4224)
    Lq, Lr = 1024, 4224
    qs, rs = [], []
    for d0 in (0, 1700, 3300):
        ref = rng.integers(0, 4, Lr).astype(np.uint8)
        frag = ref[d0: d0 + int(rng.integers(700, 900))].copy()
        pos = rng.integers(0, len(frag), len(frag) // 10)
        frag[pos] = (frag[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
        qs.append(np.delete(frag, rng.integers(0, len(frag), 20)))
        rs.append(ref[: int(rng.integers(Lr - 140, Lr + 1))])
    qs.append(np.empty(0, np.uint8))
    rs.append(rng.integers(0, 4, 100).astype(np.uint8))
    q, ql, r, rl, d0 = arrays(qs, rs, [0] * len(qs), Lq, Lr)
    sc = j_align.Scoring(2, -2, 3, 1)
    want = j_align.posterior_summary(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(rl), sc)
    got = run_torch(q, ql, r, rl, d0, sc)
    assert_equal(want, got)
    assert got.matched[:3].any(dim=1).all()
    assert int(t_align.summary_spans(got).r_end[2]) > 3300


def test_full_lane_chunks_cover_lanes_within_the_budget():
    """A full-width call launches its lanes in chunks that cover [0, N)
    once, in order, each with at most HM_BUDGET_BYTES of hm scratch; the
    main path's widest call (1,024 lanes of 640 x 640) stays one launch,
    and one lane over the budget runs alone, raising, naming the limit,
    only where the card's free memory cannot hold it."""
    budget = cuda_align.HM_BUDGET_BYTES
    assert cuda_align.full_lane_chunks(1024, 640, 640) == [(0, 1024)]
    for N, Lq, W in ((1, 640, 640), (64, 4224, 4224), (1024, 4224, 4224),
                     (64, 8192, 8192), (2, 16384, 16384), (5, 128, 16384),
                     (0, 640, 640)):
        chunks = cuda_align.full_lane_chunks(N, Lq, W)
        covered = [n for lo, hi in chunks for n in range(lo, hi)]
        assert covered == list(range(N))
        for lo, hi in chunks:
            assert hi > lo
            assert (hi - lo) * cuda_align.full_hm_lane_bytes(Lq, W) <= budget
        assert cuda_align.full_hm_lane_bytes(Lq, W) == (
            (Lq + 32) * ((W + 127) // 128 * 128) * 2)
    assert len(cuda_align.full_lane_chunks(64, 8192, 8192)) > 1
    per = cuda_align.full_hm_lane_bytes(70000, 16384)
    assert per > budget
    assert cuda_align.full_lane_chunks(1, 70000, 16384) == [(0, 1)]
    with pytest.raises(ValueError, match="HM_BUDGET_BYTES"):
        cuda_align.full_lane_chunks(1, 70000, 16384, free_bytes=per - 1)
    assert cuda_align.FULL_MAX_W == 16384


def test_bands_are_32_64_and_every_multiple_of_128_to_1024():
    assert cuda_align.BANDS == (32, 64, 128, 256, 384, 512, 640, 768, 896,
                                1024)
