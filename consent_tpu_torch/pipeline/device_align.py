"""Batched device aligner for the stitcher.

Pads ragged (query, ref) pair lists into fixed-shape buckets (lane
count = power of two, lengths = multiples of 128), runs the posterior
aligner (the full-width kernel on the card, its plain version on the
CPU), and returns host AlignSpans, read off the call's [n, 5] spans
(`SpanRows`).  A batch is held as `Pairs`, two compact blobs with
offsets: lists of arrays are gathered into one, and a caller that holds
its requests so already (the native stitch table) hands its own over as
`Pairs.sides()`.  The wire rows are packed natively (spans_wire.cpp).
On the card each bucket shape
(N, Lq, Lr) is captured as a CUDA graph at its first use and replayed
after (ops/graphs.py), as the JAX package jits the call per static
(Lq, Lr).

With a mesh (ConsensusEngine.mesh), the lane batch is split over all
of the mesh's shards, data and frag alike, as the JAX package's
shard_map splits it over every device of its mesh.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from consent_tpu_torch.ops import align as align_ops
from consent_tpu_torch.ops import cuda_align
from consent_tpu_torch.ops import graphs as graph_ops
from consent_tpu_torch.ops.consensus import _bitcast32, unpack_bases
from consent_tpu_torch.parallel.mesh import run_call
from consent_tpu_torch.pipeline.stitch import STITCH_SCORING, AlignSpan
from consent_tpu_torch.utils.observe import GLOBAL_STATS as STATS

MAX_LANES_PER_CALL = 1024

_SCORING = align_ops.Scoring(
    match=STITCH_SCORING["match"],
    mismatch=STITCH_SCORING["mismatch"],
    gap_open=STITCH_SCORING["gap_open"],
    gap_extend=STITCH_SCORING["gap_extend"],
)


def resolve_device(device) -> torch.device:
    """The device a pipeline entry point runs on, a card with its index
    (the current one for "cuda"); raises when CUDA is asked for and
    there is no card (it never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _spans_wire_body(buf: torch.Tensor, *, Lq: int, Lr: int) -> torch.Tensor:
    """Single-buffer call: ONE upload (2-bit packed q|r + lengths) and
    ONE [N, 5] int32 download (q_begin, q_end, r_begin, r_end, valid)."""
    o = 0
    q = unpack_bases(buf[:, : Lq // 4], Lq)
    o += Lq // 4
    r = unpack_bases(buf[:, o : o + Lr // 4], Lr)
    o += Lr // 4
    ql = _bitcast32(buf[:, o : o + 4])[:, 0].contiguous()
    rl = _bitcast32(buf[:, o + 4 : o + 8])[:, 0].contiguous()
    res = cuda_align.posterior_summary(q, ql, r, rl, _SCORING)
    s = align_ops.summary_spans(res)
    return torch.stack(
        [s.q_begin, s.q_end, s.r_begin, s.r_end, s.valid.to(torch.int32)],
        dim=1,
    ).to(torch.int32)


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


def _next_pow2(x: int) -> int:
    n = 8
    while n < x:
        n *= 2
    return n


class Pairs:
    """(query, ref) pairs as two compact uint8 blobs: pair i's query is
    q_rows[q_off[i] : q_off[i] + q_len[i]], its ref r_rows[r_off[i] :
    r_off[i] + r_len[i]] (int64 offsets and lengths)."""

    __slots__ = ("q_rows", "q_off", "q_len", "r_rows", "r_off", "r_len")

    def __init__(self, q_rows, q_off, q_len, r_rows, r_off, r_len):
        self.q_rows, self.q_off, self.q_len = q_rows, q_off, q_len
        self.r_rows, self.r_off, self.r_len = r_rows, r_off, r_len

    @classmethod
    def of(cls, qs, rs) -> "Pairs":
        """From lists of code arrays."""
        return cls(*_blob(qs), *_blob(rs))

    def __len__(self) -> int:
        return len(self.q_len)

    def sides(self) -> tuple:
        """(qs, rs): the queries and the refs as sequences of arrays, for
        an aligner's dispatch(qs, rs)."""
        return PairSide(self, 0), PairSide(self, 1)

    def host_spans(self) -> np.ndarray:
        """The pairs' spans by the native host aligner, [n, 5] int32."""
        from consent_tpu_torch import native

        return native.posterior_spans_native(
            self.q_rows, self.q_off, self.q_len, self.r_rows, self.r_off,
            self.r_len, **STITCH_SCORING)


class PairSide:
    """The queries (side 0) or refs (side 1) of `pairs` as a sequence of
    array views, made at the first read of a lane."""

    __slots__ = ("pairs", "side", "_views")

    def __init__(self, pairs: Pairs, side: int):
        self.pairs = pairs
        self.side = side
        self._views: Optional[List[np.ndarray]] = None

    def _lanes(self) -> List[np.ndarray]:
        if self._views is None:
            p = self.pairs
            blob, off, ln = ((p.q_rows, p.q_off, p.q_len) if self.side == 0
                             else (p.r_rows, p.r_off, p.r_len))
            self._views = [blob[o : o + n]
                           for o, n in zip(off.tolist(), ln.tolist())]
        return self._views

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i):
        return self._lanes()[i]

    def __iter__(self):
        return iter(self._lanes())


class SpanRows:
    """A call's spans as its [n, 5] int32 rows (q_begin, q_end, r_begin,
    r_end, valid), read lane by lane as AlignSpans."""

    __slots__ = ("rows",)

    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> AlignSpan:
        r = self.rows[i]
        return AlignSpan(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                         bool(r[4]))

    def __iter__(self):
        return (self[i] for i in range(len(self.rows)))


def _blob(arrays):
    """uint8 arrays end to end, with each one's offset and length."""
    n = len(arrays)
    ln = np.fromiter(map(len, arrays), np.int64, n)
    off = np.zeros(n, np.int64)
    np.cumsum(ln[:-1], out=off[1:])
    blob = np.concatenate(arrays) if n else np.empty(0, np.uint8)
    return np.ascontiguousarray(blob, dtype=np.uint8), off, ln


def device_batch_align(qs: List[np.ndarray], rs: List[np.ndarray],
                       fixed_len: Optional[int] = None, mesh=None,
                       device="cuda", graphs: bool = True
                       ) -> List[AlignSpan]:
    """Align each (qs[i], rs[i]) pair locally on the device (split over
    `mesh` when given); returns spans.

    fixed_len pins the padded sequence length so every call hits one
    captured shape; without it the lengths round up to the batch
    maxima."""
    dev = resolve_device(device) if mesh is None else None
    out: List[AlignSpan] = []
    for lo in range(0, len(qs), MAX_LANES_PER_CALL):
        out.extend(_collect(_dispatch_one(
            qs[lo : lo + MAX_LANES_PER_CALL],
            rs[lo : lo + MAX_LANES_PER_CALL], fixed_len, dev, graphs,
            mesh)))
    return out


# at or below this lane count a device stitch round is pure launch
# latency; the native host path (posterior_spans_batch, bit-equal
# contract) wins outright AND frees the device for the consensus stage
NATIVE_MAX_LANES = 8


class FixedAligner:
    """Stitch aligner with shapes pinned for one pipeline config.

    Exposes the async protocol the stitch uses to interleave job groups
    (dispatch returns as soon as the work is queued on the device;
    collect blocks on the fetch and gives SpanRows).  dispatch takes
    lists of arrays, or a Pairs' sides as they are.  Batches of at most
    NATIVE_MAX_LANES on a card route to the native host aligner (same
    span contract).  Calls on the card replay captured graphs;
    graphs=False runs them op by op, for comparison only."""

    def __init__(self, cfg, device="cuda", graphs=True, mesh=None):
        self.fixed_len = _round_up(
            max(cfg.window_size + 2 * cfg.window_overlap,
                cfg.window_size + cfg.frag_slack),
            128,
        )
        self.device = resolve_device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.mesh = mesh

    def _small_on_host(self) -> bool:
        # on the CPU every batch stays the plain aligner's, as the
        # reference's
        return self.device.type == "cuda"

    def dispatch(self, qs, rs):
        pairs = qs.pairs if isinstance(qs, PairSide) else Pairs.of(qs, rs)
        if len(pairs) <= NATIVE_MAX_LANES and self._small_on_host():
            STATS.add("stitch.host_lanes", len(pairs))
            return ("done", SpanRows(pairs.host_spans()))
        assert len(pairs) <= MAX_LANES_PER_CALL
        return ("dev", _dispatch_pairs(pairs, self.fixed_len, self.device,
                                       self.graphs, self.mesh))

    def collect(self, handle):
        kind, payload = handle
        if kind == "done":
            return payload
        return _collect(payload)

    def __call__(self, qs, rs):
        out: List[AlignSpan] = []
        for lo in range(0, len(qs), MAX_LANES_PER_CALL):
            out.extend(self.collect(self.dispatch(
                qs[lo : lo + MAX_LANES_PER_CALL],
                rs[lo : lo + MAX_LANES_PER_CALL])))
        return out


def _wire_buffer(pairs: Pairs, fixed_len=None, n_shards=1):
    """The wire rows of one call over n_shards shards (_spans_wire_body's
    layout), the lanes past the pairs zero; returns (buf, per, Lq, Lr):
    per lanes a shard, a power of two, and the lengths multiples of 128
    and at least fixed_len."""
    from consent_tpu_torch import native

    per = _next_pow2(-(-len(pairs) // n_shards))
    Lq = _round_up(int(pairs.q_len.max()), 128)
    Lr = _round_up(int(pairs.r_len.max()), 128)
    if fixed_len is not None:
        Lq = max(Lq, fixed_len)
        Lr = max(Lr, fixed_len)
    buf = native.spans_wire_pack(
        pairs.q_rows, pairs.q_off, pairs.q_len, pairs.r_rows, pairs.r_off,
        pairs.r_len, Lq, Lr, n_shards * per)
    return buf, per, Lq, Lr


def _dispatch_pairs(pairs: Pairs, fixed_len=None, device=None,
                    graphs=False, mesh=None):
    """Queue one batched span call on the device, or split over the
    shards of `mesh` (a captured graph's replay per shard on a card when
    `graphs`); returns (Pending, n) — _collect fetches it."""
    devs = [device] if mesh is None else mesh.devices()
    buf, per, Lq, Lr = _wire_buffer(pairs, fixed_len, len(devs))
    fn = functools.partial(_spans_wire_body, Lq=Lq, Lr=Lr)
    key = ("stitch", per, Lq, Lr)
    parts = [run_call(dev, fn, buf[k * per : (k + 1) * per], graphs, key)
             for k, dev in enumerate(devs)]
    pending = parts[0] if len(devs) == 1 else graph_ops.Joined(parts)
    return pending, len(pairs)


def _dispatch_one(qs, rs, fixed_len=None, device=None, graphs=False,
                  mesh=None):
    """_dispatch_pairs of lists of arrays."""
    return _dispatch_pairs(Pairs.of(qs, rs), fixed_len, device, graphs,
                           mesh)


def _collect(handle) -> SpanRows:
    pending, n = handle
    return SpanRows(pending.result()[:n])
