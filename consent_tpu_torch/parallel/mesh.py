"""Device meshes and sharded consensus dispatch (PyTorch).

The counterpart of consent_tpu/parallel/mesh.py.  There a mesh is a
jax.sharding.Mesh over the local devices and each call runs under
shard_map; here a mesh is a (data, frag) grid of torch.devices, and the
calling thread enqueues every shard's work on its device in turn, as
the JAX package drives all local devices from one process:

  * `data` — the windows of a batch split over devices (no collective);
    each shard runs the one-device call on its rows, on the card a
    replay of the call captured for its shape (ops/graphs.py);
  * `frag` — the fragment slots of each window split over devices; the
    vote reductions become sums of the shards' partials: phase A
    (ops/consensus.py: frag_phase_a) on each shard, the partials added
    in shard order on the data row's first shard and copied back to
    every shard, phase B there (consensus_votes_rounds_frag).  On a
    card each data row's call is a chain of captured graphs
    (ops/graphs.py: FragChain): each shard's slots travel as one wire
    buffer, and the result comes back as the data axis's does
    (sharded_frag_wire_step); graphs=False and the CPU run it op by op.

A device list may repeat a device, as the JAX package's tests run on
XLA's virtual host devices: shards of one card, or of the CPU.  Every
mesh device carries its index, and all work of a card runs on its one
work stream (ops/graphs.py).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from consent_tpu_torch.ops import align as align_ops
from consent_tpu_torch.ops import consensus as cons_ops
from consent_tpu_torch.ops import graphs as graph_ops


class Mesh:
    """A (data, frag) grid of devices; row d holds data shard d's frag
    shards."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or len({len(row) for row in self.grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.grid), len(self.grid[0])

    def devices(self) -> List[torch.device]:
        """Every shard's device, data-major."""
        return [d for row in self.grid for d in row]

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in order of first use."""
        return list(dict.fromkeys(self.devices()))


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device="cuda") -> List[torch.device]:
    """The devices a pipeline uses by default: every local card for
    "cuda" (cuda:0 .. cuda:n-1), the one named card for "cuda:i", the
    CPU for "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [_indexed(dev)]


def make_mesh(devices: Optional[Sequence] = None, frag_axis: int = 1) -> Mesh:
    """(data, frag) mesh over `devices` (default: every local card),
    frag_axis devices per data row."""
    devs = [_indexed(d) for d in (devices if devices is not None
                                  else local_devices())]
    n = len(devs)
    if frag_axis < 1 or n % frag_axis:
        raise ValueError(f"{n} devices do not split into frag rows of "
                         f"{frag_axis}")
    return Mesh([devs[i : i + frag_axis] for i in range(0, n, frag_axis)])


def make_data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Data-only mesh over `devices` (the engine's mesh)."""
    return make_mesh(devices, frag_axis=1)


def _split(n: int, parts: int, i: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split into {parts} shards")
    step = n // parts
    return slice(i * step, (i + 1) * step)


def put_batch(mesh: Mesh, arrays, specs) -> List[List[tuple]]:
    """Host (or device) arrays split over the mesh: specs name each
    array's axes, "data", "frag" or None (not split), as the JAX
    package's PartitionSpecs do.  Returns grid[d][f] = the tuple of
    shard (d, f)'s tensors, on its device."""
    nd, nf = mesh.shape
    out = []
    for d, row in enumerate(mesh.grid):
        out_row = []
        for f, dev in enumerate(row):
            shard = []
            for a, spec in zip(arrays, specs):
                idx = []
                for axis, name in enumerate(spec):
                    if name is None:
                        idx.append(slice(None))
                    else:
                        parts, i = (nd, d) if name == "data" else (nf, f)
                        idx.append(_split(a.shape[axis], parts, i, name))
                part = a[tuple(idx)]
                if isinstance(part, np.ndarray):
                    part = torch.from_numpy(np.ascontiguousarray(part))
                shard.append(part.to(dev).contiguous())
            out_row.append(tuple(shard))
        out.append(out_row)
    return out


def _row_step(shards, S, min_column_support, scoring, rounds, assemble_out,
              packed, warm_frac):
    """One data row's consensus over its frag shards; the first shard's
    result (every shard's is the same)."""
    if len(shards) == 1:
        sh = shards[0]
        if rounds > 1 or assemble_out:
            v, w_len = cons_ops.consensus_votes_rounds(
                sh.frags, sh.frag_len, sh.tpl, sh.tpl_len, S=S,
                rounds=rounds, min_column_support=min_column_support,
                scoring=scoring, frag_d0=sh.frag_d0, warm_frac=warm_frac)
        else:
            v, w_len = cons_ops.consensus_votes(
                sh.frags, sh.frag_len, sh.tpl, sh.tpl_len, S=S,
                min_column_support=min_column_support, scoring=scoring,
                frag_d0=sh.frag_d0), None
    else:
        v, w_len = cons_ops.consensus_votes_rounds_frag(
            shards, S=S, rounds=rounds,
            min_column_support=min_column_support, scoring=scoring,
            warm_frac=warm_frac)[0]
    if assemble_out:
        cons, cl = cons_ops.assemble_template_device(
            v, w_len, shards[0].tpl.shape[1])
        return cons_ops.pack_bases_device(cons), cl
    out = cons_ops.pack_votes(v) if packed else v
    return (out, w_len) if rounds > 1 else out


def _gather(rows):
    """Per-data-row results (tensors, tuples or NamedTuples of them)
    joined along the windows, on the host."""
    first = rows[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([r.cpu() for r in rows])
    parts = [_gather([r[i] for r in rows]) for i in range(len(first))]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def sharded_consensus_step(
    mesh: Mesh,
    frags,
    frag_len,
    tpl,
    tpl_len,
    *,
    S: int,
    min_column_support: int = 2,
    scoring: align_ops.Scoring = align_ops.Scoring(),
    frag_d0=None,
    packed: bool = False,
    frags_packed: bool = False,
    rounds: int = 1,
    assemble_out: bool = False,
    warm_frac: float = 1.0,
    graphs: bool = False,
):
    """One device-parallel consensus step: the window batch split over
    `data`, fragment slots over `frag` (the vote reductions become sums
    of the shards' partials).  Inputs are host arrays or tensors with
    leading dim B divisible by the data-axis size (and S by the frag
    size); the results come back to the host as CPU tensors, in the
    JAX package's structure: WindowVotes, or PackedVotes with
    packed=True; with rounds > 1, (votes, final template lengths);
    with assemble_out, the 2-bit-packed assembled consensus and its
    lengths.

    graphs=True on a card mesh with a frag axis replays each data row's
    captured frag chain instead (sharded_frag_wire_step) and returns a
    graphs.Joined of the assembled consensus in consensus_votes_wire's
    assemble_out layout; it takes host arrays, packed fragments and
    assemble_out=True only.  On the CPU graphs is ignored."""
    nd, nf = mesh.shape
    if S % nf:
        raise ValueError(f"S={S} does not split into {nf} frag shards")
    if graphs and nf > 1 and mesh.grid[0][0].type == "cuda":
        if not (assemble_out and frags_packed):
            raise ValueError("captured frag calls take packed fragments "
                             "and return the assembled consensus")
        d0 = (np.zeros(frag_len.shape, np.int32) if frag_d0 is None
              else frag_d0)
        return sharded_frag_wire_step(
            mesh, frags, frag_len, tpl, tpl_len, d0, S=S, Lt=tpl.shape[1],
            min_column_support=min_column_support, scoring=scoring,
            rounds=rounds, warm_frac=warm_frac)
    frag = "frag" if nf > 1 else None
    specs = [("data", frag, None), ("data", frag), ("data", None), ("data",)]
    arrays = [frags, frag_len, tpl, tpl_len]
    if frag_d0 is not None:
        specs.append(("data", frag))
        arrays.append(frag_d0)
    with graph_ops.work_streams(mesh.devices()):
        grid = put_batch(mesh, arrays, specs)
        rows = []
        for row in grid:
            shards = []
            for fr, fl, tp, tl, *d0 in row:
                if frags_packed:
                    fr = cons_ops.unpack_bases(fr, fr.shape[-1] * 4)
                shards.append(cons_ops.SlotShard(fr, fl, tp, tl,
                                                 d0[0] if d0 else None))
            rows.append(_row_step(shards, S // nf, min_column_support,
                                  scoring, rounds, assemble_out, packed,
                                  warm_frac))
        return _gather(rows)


def frag_wire_bufs(mesh: Mesh, frags_packed: np.ndarray,
                   frag_len: np.ndarray, tpl: np.ndarray,
                   tpl_len: np.ndarray, frag_d0: np.ndarray
                   ) -> List[List[np.ndarray]]:
    """Host: grid[d][k] = shard (d, k)'s wire buffer (wire_encode_inputs'
    layout): data row d's windows, frag shard k's S/nf slots of each,
    and the windows' templates."""
    nd, nf = mesh.shape
    B, S = frag_len.shape
    out = []
    for d in range(nd):
        rows = _split(B, nd, d, "window batch")
        out.append([])
        for k in range(nf):
            sl = (rows, _split(S, nf, k, "frag"))
            out[-1].append(cons_ops.wire_encode_inputs(
                frags_packed[sl], frag_len[sl], tpl[rows], tpl_len[rows],
                frag_d0[sl]))
    return out


def sharded_frag_wire_step(mesh: Mesh, frags_packed, frag_len, tpl, tpl_len,
                           frag_d0, *, S, Lt, min_column_support, scoring,
                           rounds=1, warm_frac=1.0) -> graph_ops.Joined:
    """The frag-axis consensus call on a card mesh (the engine's deep-pile
    path): each data row's shards take their wire buffers
    (frag_wire_bufs), staged through pinned memory, and the row's call
    is a replay of its captured frag chain (ops/graphs.py: FragChain).
    Returns the rows' assembled consensus, joined on the host in row
    order, when read (graphs.Joined)."""
    nd, nf = mesh.shape
    Pb = frags_packed.shape[-1]
    parts = []
    for d, bufs in enumerate(frag_wire_bufs(mesh, frags_packed, frag_len,
                                            tpl, tpl_len, frag_d0)):
        parts.append(frag_call(mesh, d, S // nf, bufs[0].shape[0], Pb, Lt,
                               min_column_support, scoring, rounds,
                               warm_frac)(bufs))
    return graph_ops.Joined(parts)


def frag_call(mesh: Mesh, d: int, S: int, B: int, Pb: int, Lt: int,
              min_column_support, scoring, rounds, warm_frac
              ) -> graph_ops.FragChain:
    """Data row d's captured frag chain for S local slots and B windows
    a shard (captured at first use)."""
    return graph_ops.frag_chain(
        wire_key(S, B, Pb, Lt, min_column_support, scoring, rounds, True,
                 warm_frac),
        mesh.grid[d], B, row=d, S=S, Pb=Pb, Lt=Lt,
        min_column_support=min_column_support, scoring=scoring,
        rounds=rounds, warm_frac=warm_frac)


def wire_key(S, B, Pb, Lt, min_column_support, scoring, rounds,
             assemble_out, warm_frac) -> tuple:
    """The key of one shard's captured consensus call: what the JAX
    package's consensus_votes_wire takes as static."""
    return ("consensus", S, B, Pb, Lt, min_column_support, scoring, rounds,
            assemble_out, warm_frac)


def sharded_wire_step(mesh: Mesh, buf: np.ndarray, *, S, Pb, Lt,
                      min_column_support, scoring, rounds=1,
                      assemble_out=False, warm_frac=1.0,
                      graphs: bool = True) -> graph_ops.Joined:
    """Wire-format consensus step split over the `data` axis (the
    engine's production path): shard d takes rows [d*B/nd, (d+1)*B/nd)
    of the host buffer and runs the one-device call on its row's first
    device, on a card as a replay of the call captured for its shape
    (graphs=False: op by op).  The shards' results join on the host in
    shard order."""
    nd = mesh.shape[0]
    fn = functools.partial(
        cons_ops.consensus_votes_wire, S=S, Pb=Pb, Lt=Lt,
        min_column_support=min_column_support, scoring=scoring,
        rounds=rounds, assemble_out=assemble_out, warm_frac=warm_frac)
    parts = []
    for d, row in enumerate(mesh.grid):
        part = buf[_split(buf.shape[0], nd, d, "window batch")]
        parts.append(run_call(row[0], fn, part, graphs, wire_key(
            S, part.shape[0], Pb, Lt, min_column_support, scoring, rounds,
            assemble_out, warm_frac)))
    return graph_ops.Joined(parts)


def run_call(dev: torch.device, fn, part: np.ndarray, graphs: bool,
             key: tuple) -> graph_ops.Pending:
    """fn on one shard's host buffer, enqueued on `dev`: the plain path
    on the CPU, the call captured for `key` on a card (graphs=False: op
    by op on the card's work stream)."""
    if dev.type == "cpu":
        return graph_ops.Pending(fn(torch.from_numpy(
            np.ascontiguousarray(part))))
    if graphs:
        return graph_ops.captured(key, fn, part.shape, dev)(part)
    return graph_ops.run_eager(fn, part, dev)
