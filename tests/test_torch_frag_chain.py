"""The captured frag-axis call's host side, on the CPU.

On the card each data row's frag-axis consensus call is a chain of
captured graphs (consent_tpu_torch/ops/graphs.py: FragChain): each
shard's phase A, the partials copied to the row's first shard and summed
there in shard order with its phase B, the sums copied back and each
other shard's phase B, the last round's phase B packing the consensus.
Here the same chain runs with every graph's function called in place of
its replay (StubFragChain), on meshes of CPU shards, and must equal,
byte for byte (tolerance 0: every output is an integer), the op-by-op
frag path (consensus_votes_rounds_frag) and the JAX package's
sharded_consensus_step on its 8 virtual devices.  The captures and
replays themselves run on the card only (chip_smoke.py: mesh phase)."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consent_tpu.ops import align as j_align
from consent_tpu.parallel import mesh as j_mesh
from consent_tpu_torch.ops import align as t_align
from consent_tpu_torch.ops import consensus as t_cons
from consent_tpu_torch.ops import cuda_align
from consent_tpu_torch.ops import graphs as graph_ops
from consent_tpu_torch.parallel import mesh as t_mesh

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
B, S, L = 4, 16, 128


class StubFragChain(graph_ops.FragChain):
    """A frag chain whose card side runs on the CPU: a capture keeps the
    piece's function, a replay calls it, staging copies in place."""

    def _enqueue(self):
        return contextlib.nullcontext()

    def _capture_piece(self, k, fn):
        return fn, []

    def _replay_piece(self, k, fn):
        fn()

    def _stage_in(self, k, buf):
        self.ins[k].copy_(torch.from_numpy(buf))

    def _stage_out(self):
        return graph_ops.Pending(self.out.clone())


class CardPerShardStub(StubFragChain):
    """The stub as if every shard had a card of its own: the partials
    and sums are copied between the shards' static tensors, as between
    cards."""

    def _shares_first_card(self, k):
        return k == 0


def _inputs(seed):
    """Near-copies of each window's template at small offsets, ragged
    piles (a window whose upper slots are all empty), 2-bit packed."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (B, L)).astype(np.uint8)
    frags = np.zeros((B, S, L), dtype=np.uint8)
    frag_len = np.zeros((B, S), dtype=np.int32)
    for b in range(B):
        for s in range(S):
            n = L - int(rng.integers(0, 8))
            f = tpl[b, :n].copy()
            pos = rng.integers(0, n, max(1, n // 12))
            f[pos] = (f[pos] + 1) % 4
            frags[b, s, :n] = f
            frag_len[b, s] = n
    frag_len[-1, S // 2:] = 0
    tpl_len = np.full(B, L, np.int32)
    tpl_len[1] = L - 9
    d0 = rng.integers(-3, 4, (B, S)).astype(np.int32)
    return t_cons.pack_bases_host(frags), frag_len, tpl, tpl_len, d0


SC = dict(min_column_support=2)
T_SC = t_align.Scoring(max_hgap=16, band=128)
J_SC = j_align.Scoring(max_hgap=16, band=128)


def _chain_rows(mesh, arrays, rounds, warm_frac, poison=False,
                stub=StubFragChain):
    """Each data row's stub chain over its wire buffers, the rows'
    outputs joined: consensus_votes_wire's assemble_out layout."""
    nd, nf = mesh.shape
    out = []
    for d, bufs in enumerate(t_mesh.frag_wire_bufs(mesh, *arrays)):
        chain = stub(mesh.grid[d], bufs[0].shape[0], S=S // nf,
                              Pb=L // 4, Lt=L, scoring=T_SC, rounds=rounds,
                              warm_frac=warm_frac, row=d, **SC)
        chain.capture()
        if poison:
            for t in chain.static_tensors():
                t.view(torch.uint8).fill_(0xA5)
        out.append(chain(bufs).result())
        n_graphs = nf * rounds + nf * (rounds - 1) + 1   # A, B, last B
        assert chain.n_graphs == n_graphs
        assert chain.replays == n_graphs
        assert all(chain.shard_replays)
    return np.concatenate(out)


@pytest.mark.parametrize("warm_frac", [0.25, 1.0])
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("nf", [2, 4, 8])
def test_chain_equals_op_by_op_frag_path_and_jax(nf, rounds, warm_frac):
    """The phase functions chained as the card chains them equal the
    op-by-op frag path and JAX's jit(shard_map) on 8 virtual devices."""
    pk, frag_len, tpl, tpl_len, d0 = arrays = _inputs(nf + 10 * rounds)
    mesh = t_mesh.make_mesh(CPU8, frag_axis=nf)
    got = _chain_rows(mesh, arrays, rounds, warm_frac,
                      poison=rounds == 2)

    cons, lens = t_mesh.sharded_consensus_step(
        mesh, pk, frag_len, tpl, tpl_len, S=S, scoring=T_SC, frag_d0=d0,
        frags_packed=True, rounds=rounds, assemble_out=True,
        warm_frac=warm_frac, **SC)
    eager = torch.cat([cons, t_cons._bytes32(lens[:, None])], 1).numpy()
    assert got.dtype == eager.dtype and got.shape == eager.shape
    assert np.array_equal(got, eager)

    jc, jl = j_mesh.sharded_consensus_step(
        j_mesh.make_mesh(8, frag_axis=nf),
        *map(jnp.asarray, (pk, frag_len, tpl, tpl_len)), S=S, scoring=J_SC,
        frag_d0=jnp.asarray(d0), frags_packed=True, rounds=rounds,
        assemble_out=True, warm_frac=warm_frac, **SC)
    want = np.concatenate([np.asarray(jc),
                           np.asarray(jl, np.int32)[:, None].view(np.uint8)],
                          axis=1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("stub", [StubFragChain, CardPerShardStub])
@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_chain_equals_one_device_wire_call(rounds, stub):
    """A frag-4 chain, its shards on one card or each on its own (the
    partials and sums copied between them), from poisoned static
    tensors, equals the one-device consensus call on the whole wire
    buffer (the engine's data path); 3 rounds chain two middle rounds."""
    arrays = _inputs(3)
    got = _chain_rows(t_mesh.make_mesh(["cpu"] * 4, frag_axis=4), arrays,
                      rounds, 0.25, poison=True, stub=stub)
    want = t_cons.consensus_votes_wire(
        torch.from_numpy(t_cons.wire_encode_inputs(*arrays)), S=S,
        Pb=L // 4, Lt=L, scoring=T_SC, rounds=rounds, assemble_out=True,
        warm_frac=0.25, **SC).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nf", [2, 4])
def test_frag_wire_bufs_decode_to_put_batch(nf):
    """Each shard's wire buffer decodes (wire_split) to put_batch's
    tensors for that shard: frags unpacked, lengths, template, d0."""
    pk, frag_len, tpl, tpl_len, d0 = arrays = _inputs(5)
    mesh = t_mesh.make_mesh(CPU8, frag_axis=nf)
    grid = t_mesh.put_batch(
        mesh, list(arrays), [("data", "frag", None), ("data", "frag"),
                             ("data", None), ("data",), ("data", "frag")])
    bufs = t_mesh.frag_wire_bufs(mesh, *arrays)
    for d, row in enumerate(grid):
        for k, (fr, fl, tp, tl, dd) in enumerate(row):
            got = t_cons.wire_split(torch.from_numpy(bufs[d][k]), S=S // nf,
                                    Pb=L // 4, Lt=L)
            want = (t_cons.unpack_bases(fr, L), fl, tp, tl, dd)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_partials_spec_is_the_partials_layout():
    pk, frag_len, tpl, tpl_len, d0 = _inputs(6)
    frags = t_cons.unpack_bases(torch.from_numpy(pk), L)
    p = t_cons.consensus_partials(frags, torch.from_numpy(frag_len),
                                  torch.from_numpy(tpl),
                                  torch.from_numpy(tpl_len), S=S,
                                  scoring=T_SC, frag_d0=torch.from_numpy(d0))
    spec = t_cons.partials_spec(B, L)
    assert [(tuple(x.shape), x.dtype) for x in p] == \
        [(tuple(sh), dt) for sh, dt in spec]


def test_frag_chain_needs_a_cuda_device():
    """The captured frag call raises on CPU devices; on a CPU mesh
    graphs=True keeps the plain path and its return type."""
    with pytest.raises(ValueError):
        graph_ops.frag_chain(("consensus", 4), ["cpu", "cpu"], 8, S=4,
                             Pb=L // 4, Lt=L, scoring=T_SC, rounds=2,
                             warm_frac=1.0, **SC)
    pk, frag_len, tpl, tpl_len, d0 = _inputs(7)
    res = t_mesh.sharded_consensus_step(
        t_mesh.make_mesh(["cpu"] * 2, frag_axis=2), pk, frag_len, tpl,
        tpl_len, S=S, scoring=T_SC, frag_d0=d0, frags_packed=True,
        assemble_out=True, graphs=True, **SC)
    assert isinstance(res, tuple) and len(res) == 2


def test_replays_are_not_eager_launches():
    """The eager-launch count takes a wrapper's launches outside a
    capture only: recorded launches and a replay's added ones stay out."""
    try:
        cuda_align.reset_launch_counts()
        cuda_align._count("banded_posterior", 64)
        with cuda_align.recording() as rec:
            cuda_align._count("banded_posterior", 32)
        cuda_align.add_launches(rec * 3)
        assert cuda_align.launch_counts()["banded_posterior"] == 4
        assert cuda_align.eager_launch_counts() == {"banded_posterior": 1,
                                                    "full_posterior": 0}
        cuda_align.reset_launch_counts()
        assert cuda_align.eager_launch_counts()["banded_posterior"] == 0
    finally:
        cuda_align.reset_launch_counts()
