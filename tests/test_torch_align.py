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
@pytest.mark.parametrize("band", [0, 128, 256])
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
