"""The port's device mesh on the CPU against the JAX package's.

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port on
a mesh of 8 shards of the CPU ([cpu] x 8).  The same numpy inputs go
through both; every output is an integer or a byte, so the tolerance is
0: the port's sharded calls must equal its one-device calls and the
JAX package's sharded calls, field by field and byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consent_tpu.config import correct_preset, polish_preset
from consent_tpu.io.fasta import ReadIndex
from consent_tpu.ops import align as j_align
from consent_tpu.ops import consensus as j_cons
from consent_tpu.parallel import mesh as j_mesh
from consent_tpu.pipeline import device_align as j_dalign
from consent_tpu.pipeline import engine as j_engine
from consent_tpu.testing import simulate
from consent_tpu_torch.config import from_reference
from consent_tpu_torch.io.fasta import ReadIndex as TReadIndex
from consent_tpu_torch.ops import align as t_align
from consent_tpu_torch.ops import consensus as t_cons
from consent_tpu_torch.parallel import mesh as t_mesh
from consent_tpu_torch.pipeline import device_align as t_dalign
from consent_tpu_torch.pipeline import engine as t_engine
from consent_tpu_torch.testing import simulate as t_simulate

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _inputs(B, S, Lf, W, seed=0):
    """tests/test_parallel.py's inputs: near-copies of each window's
    template, plus frag_d0 offsets."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (B, W)).astype(np.uint8)
    frags = np.zeros((B, S, Lf), dtype=np.uint8)
    frag_len = np.zeros((B, S), dtype=np.int32)
    for b in range(B):
        for s in range(S):
            L = W - int(rng.integers(0, 8))
            f = tpl[b, :L].copy()
            pos = rng.integers(0, L, max(1, L // 12))
            f[pos] = (f[pos] + 1) % 4
            frags[b, s, :L] = f
            frag_len[b, s] = L
    frag_len[-1, S // 2:] = 0           # a ragged pile: whole shards empty
    d0 = rng.integers(-3, 4, (B, S)).astype(np.int32)
    return frags, frag_len, tpl, np.full(B, W, np.int32), d0


def _assert_same(a, b):
    """Two results of the same structure (NamedTuples, tuples, arrays)
    equal field by field: same dtype, same bytes."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("frag_axis", [1, 2, 4])
def test_sharded_consensus_matches_single_device(frag_axis):
    """tests/test_parallel.py's three frag cases: the port's sharded
    step equals its one-device consensus_votes and JAX's sharded step."""
    B, S, Lf, W = 8, 8, 64, 64
    frags, frag_len, tpl, tpl_len, _ = _inputs(B, S, Lf, W)
    one = t_cons.consensus_votes(*map(_torch, (frags, frag_len, tpl,
                                               tpl_len)),
                                 S=S, min_column_support=2)
    got = t_mesh.sharded_consensus_step(
        t_mesh.make_mesh(CPU8, frag_axis=frag_axis), frags, frag_len, tpl,
        tpl_len, S=S)
    want = j_mesh.sharded_consensus_step(
        j_mesh.make_mesh(8, frag_axis=frag_axis), *map(
            jnp.asarray, (frags, frag_len, tpl, tpl_len)), S=S)
    _assert_same(got, one)
    _assert_same(got, tuple(np.asarray(x) for x in want))


@pytest.mark.parametrize("frag_axis", [1, 2, 4])
def test_sharded_rounds_packed_match_jax(frag_axis):
    """The engine's frag-axis call (banded aligner, packed 2-bit
    fragments, 2 fused rounds with a warm fraction, assembled output)
    and the packed-votes call equal JAX's on the same mesh shape."""
    B, S, Lf, W = 8, 16, 128, 128
    frags, frag_len, tpl, tpl_len, d0 = _inputs(B, S, Lf, W, seed=1)
    pk = t_cons.pack_bases_host(frags)
    jm = j_mesh.make_mesh(8, frag_axis=frag_axis)
    tm = t_mesh.make_mesh(CPU8, frag_axis=frag_axis)
    for kw in (dict(rounds=2, warm_frac=0.25, assemble_out=True),
               dict(rounds=2, warm_frac=0.5, packed=True),
               dict(rounds=1, packed=True)):
        want = j_mesh.sharded_consensus_step(
            jm, *map(jnp.asarray, (pk, frag_len, tpl, tpl_len)), S=S,
            min_column_support=2, scoring=j_align.Scoring(max_hgap=16,
                                                          band=128),
            frag_d0=jnp.asarray(d0), frags_packed=True, **kw)
        got = t_mesh.sharded_consensus_step(
            tm, pk, frag_len, tpl, tpl_len, S=S, min_column_support=2,
            scoring=t_align.Scoring(max_hgap=16, band=128), frag_d0=d0,
            frags_packed=True, **kw)
        _assert_same(got, want)


def test_frag_rounds_equal_slicing_path():
    """Warm rounds over a frag axis zero the lengths of global slots
    >= Sw; the votes equal the one-device path that slices them."""
    B, S, Lf, W = 4, 16, 128, 128
    frags, frag_len, tpl, tpl_len, d0 = map(_torch, _inputs(B, S, Lf, W, 2))
    sc = t_align.Scoring(max_hgap=16, band=128)
    kw = dict(rounds=3, min_column_support=2, scoring=sc, warm_frac=0.25)
    want = t_cons.consensus_votes_rounds(frags, frag_len, tpl, tpl_len,
                                         S=S, frag_d0=d0, **kw)
    nf = 4
    shards = [t_cons.SlotShard(frags[:, k * 4:(k + 1) * 4],
                               frag_len[:, k * 4:(k + 1) * 4], tpl, tpl_len,
                               d0[:, k * 4:(k + 1) * 4]) for k in range(nf)]
    got = t_cons.consensus_votes_rounds_frag(shards, S=S // nf, **kw)
    assert len(got) == nf
    for res in got:
        _assert_same(tuple(x.numpy() for x in res[0]),
                     tuple(x.numpy() for x in want[0]))
        _assert_same(res[1].numpy(), want[1].numpy())


def test_mesh_grid_and_put_batch():
    m = t_mesh.make_mesh(CPU8, frag_axis=4)
    assert m.shape == (2, 4) and len(m.devices()) == 8
    assert m.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        t_mesh.make_mesh(["cpu"] * 6, frag_axis=4)
    x = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    y = np.arange(2 * 5).reshape(2, 5)
    grid = t_mesh.put_batch(m, [x, y], [("data", "frag", None),
                                        ("data", None)])
    for d in range(2):
        for f in range(4):
            xs, ys = grid[d][f]
            assert np.array_equal(xs.numpy(), x[d:d + 1, 2 * f:2 * f + 2])
            assert np.array_equal(ys.numpy(), y[d:d + 1])


# the first piles of the simulation: every window of them goes through
# the eager plain aligner on each shard, which is slow on the CPU
N_PILES = 3


def _tiny_run(run, cfg, index_cls, sim_mod, **kw):
    """tests/test_knobs.py's _tiny_engine_run on either package, over its
    first N_PILES piles."""
    genome, reads = sim_mod.simulate(genome_len=1200, coverage=10.0,
                                     read_len=400, error_rate=0.08, seed=7)
    index = index_cls()
    for r in reads:
        index.add(r.name, r.codes)
    piles = sim_mod.piles_from_sim(reads, cfg.max_support)[:N_PILES]
    return [(name, codes.tobytes(), solid.tobytes())
            for name, codes, solid in run(iter(piles), index, cfg, **kw)]


def _jax_run(cfg):
    return _tiny_run(j_engine.process_piles, cfg, ReadIndex, simulate)


def _port_run(j_cfg):
    t_cfg = from_reference(dataclasses.asdict(j_cfg))
    return _tiny_run(t_engine.process_piles, t_cfg, TReadIndex, t_simulate,
                     devices=CPU8)


def test_engine_multi_device_matches_single_device():
    """1 against 8 devices (tests/test_knobs.py): the port's bytes equal
    on both and equal the JAX engine's."""
    outs = {}
    for nd in (1, 8):
        cfg = correct_preset(window_size=128, window_overlap=16,
                             min_support=2, consensus_rounds=1,
                             n_devices=nd)
        outs[nd] = _port_run(cfg)
        assert outs[nd] == _jax_run(cfg)
    assert outs[1] == outs[8]


def test_engine_frag_axis_matches_single_device():
    """The deep-pile (data, frag) path at frag 4 and chosen
    automatically (device_lanes 8 < s_cap): equal to one device and to
    the JAX engine."""
    outs = {}
    for nd, nf in ((1, 1), (8, 4), (8, None)):
        cfg = polish_preset(window_size=128, window_overlap=16,
                            min_support=2, consensus_rounds=1, n_devices=nd,
                            frag_devices=nf, device_lanes=8)
        eng = t_engine.ConsensusEngine(
            from_reference(dataclasses.asdict(cfg)), devices=CPU8)
        assert eng.frag_devices == ((nf or 8) if nd == 8 else 1)
        outs[(nd, nf)] = _port_run(cfg)
        assert outs[(nd, nf)] == _jax_run(cfg)
    assert outs[(1, 1)] == outs[(8, 4)] == outs[(8, None)]


def test_engine_fused_rounds_device_identity():
    """consensus_rounds=2 fused on one device, on the data axis of 8
    and on the (data, frag) mesh: the same bytes, the JAX engine's."""
    outs = {}
    for tag, kw in (("single", dict(n_devices=1)),
                    ("data8", dict(n_devices=8)),
                    ("frag", dict(n_devices=8, frag_devices=4,
                                  device_lanes=8))):
        cfg = polish_preset(window_size=128, window_overlap=16,
                            min_support=2, consensus_rounds=2, **kw)
        outs[tag] = _port_run(cfg)
        assert outs[tag] == _jax_run(cfg)
    assert outs["single"] == outs["data8"] == outs["frag"]


def test_sharded_stitch_matches_one_shard_and_jax():
    """The stitch's span call split over 8 shards: the spans equal one
    shard's and those of JAX's _dispatch_one with its 8-device mesh."""
    rng = np.random.default_rng(5)
    qs, rs = [], []
    for n in range(21):
        ref = rng.integers(0, 4, int(rng.integers(60, 200))).astype(np.uint8)
        beg = int(rng.integers(0, 30))
        frag = ref[beg: beg + int(rng.integers(20, 150))].copy()
        flip = rng.random(len(frag)) < 0.1
        frag[flip] = (frag[flip] + 1) % 4
        qs.append(frag)
        rs.append(ref)
    qs[3] = np.empty(0, np.uint8)
    def spans(handle, collect):
        return [dataclasses.astuple(s) for s in collect(handle)]

    one = spans(t_dalign._dispatch_one(qs, rs, 256, torch.device("cpu")),
                t_dalign._collect)
    got = spans(t_dalign._dispatch_one(qs, rs, 256,
                                       mesh=t_mesh.make_data_mesh(CPU8)),
                t_dalign._collect)
    want = spans(j_dalign._dispatch_one(qs, rs, 256,
                                        j_mesh.make_data_mesh(8)),
                 j_dalign._collect)
    assert got == one == want
    assert sum(v for *_, v in got) >= 18
    got = t_dalign.device_batch_align(qs, rs,
                                      mesh=t_mesh.make_data_mesh(CPU8))
    want = j_dalign.device_batch_align(qs, rs,
                                       mesh=j_mesh.make_data_mesh(8))
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]


@pytest.mark.parametrize("n, nf, lanes", [
    pytest.param(2, 1, 160, id="2"),
    pytest.param(8, 1, 160, id="8"),
    pytest.param(8, 4, 160, id="8-frag4"),          # (2, 4): frag set
    pytest.param(4, None, 64, id="4-fragauto"),     # 64 lanes < s_cap 152
])
def test_call_shapes_are_the_dispatched_shard_shapes(n, nf, lanes,
                                                     monkeypatch):
    """On a mesh the batch sizes round to the data axis (tail
    d * ceil(16 / d)), the slots split over the frag axis, and
    call_shapes() lists exactly the per-shard shapes run() dispatches
    (the shapes the engine captures on a card)."""
    cfg = from_reference(dataclasses.asdict(correct_preset(
        max_msa=10, device_lanes=lanes, frag_devices=nf)))
    eng = t_engine.ConsensusEngine(cfg, devices=["cpu"] * n)
    nf = nf or n
    nd = n // nf
    assert eng.mesh.shape == (nd, nf) and eng.max_lanes == lanes * n
    seen = set()

    def record(sub, S, arrays, rounds):
        B = arrays[0].shape[0]
        assert B % nd == 0 and S % nf == 0 and len(sub) <= B
        seen.add((S // nf, B // nd))

    monkeypatch.setattr(eng, "_job_chain", record)
    rng = np.random.default_rng(0)
    tasks = []
    for k in range(1, cfg.max_msa + 2):
        S = eng._bucket(k)
        for i in range(eng._max_b(S) + 3):
            frags = [rng.integers(0, 4, 12).astype(np.uint8)
                     for _ in range(k)]
            tasks.append(t_engine.WindowTask(read_key=i, window_idx=0,
                                             pos=(0, 12), frags=frags))
    eng.run(tasks)
    assert seen == eng.call_shapes()
    assert all(eng._pad_b(1, eng._max_b(S * nf)) % nd == 0 for S, _ in seen)
