"""Batched device aligner for the stitcher.

Pads ragged (query, ref) pair lists into fixed-shape buckets (lane
count = power of two, lengths = multiples of 128), runs the posterior
aligner (the full-width kernel on the card, its plain version on the
CPU), and returns host AlignSpans.  On the card each bucket shape
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
from consent_tpu_torch.ops.consensus import (
    _bitcast32, pack_bases_host, unpack_bases,
)
from consent_tpu_torch.parallel.mesh import run_call
from consent_tpu_torch.pipeline.stitch import STITCH_SCORING, AlignSpan

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

    Exposes the async protocol run_stitch uses to interleave job
    groups (dispatch returns as soon as the work is queued on the
    device; collect blocks on the fetch).  Tiny batches on the card
    route to the native host aligner (same span contract).  Calls on
    the card replay captured graphs; graphs=False runs them op by op,
    for comparison only."""

    def __init__(self, cfg, device="cuda", graphs=True, mesh=None):
        self.fixed_len = _round_up(
            max(cfg.window_size + 2 * cfg.window_overlap,
                cfg.window_size + cfg.frag_slack),
            128,
        )
        self.device = resolve_device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.mesh = mesh

    def _native(self, qs, rs):
        if self.device.type == "cpu":
            return None     # keep the CPU path identical to the reference
        from consent_tpu_torch import native

        out = native.posterior_spans_native(qs, rs, **STITCH_SCORING)
        return [
            AlignSpan(int(out[i, 0]), int(out[i, 1]), int(out[i, 2]),
                      int(out[i, 3]), bool(out[i, 4]))
            for i in range(len(qs))
        ]

    def dispatch(self, qs, rs):
        if len(qs) <= NATIVE_MAX_LANES:
            spans = self._native(qs, rs)
            if spans is not None:
                return ("done", spans)
        assert len(qs) <= MAX_LANES_PER_CALL
        return ("dev", _dispatch_one(qs, rs, self.fixed_len, self.device,
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


def _dispatch_one(qs, rs, fixed_len=None, device=None, graphs=False,
                  mesh=None):
    """Queue one batched span call on the device, or split over the
    shards of `mesh` (a captured graph's replay per shard on a card when
    `graphs`); returns (Pending, n) — _collect fetches it."""
    devs = [device] if mesh is None else mesh.devices()
    nd = len(devs)
    n = len(qs)
    per = _next_pow2(-(-n // nd))     # lanes of each shard
    lanes = nd * per
    Lq = _round_up(max(len(q) for q in qs), 128)
    Lr = _round_up(max(len(r) for r in rs), 128)
    if fixed_len is not None:
        Lq = max(Lq, fixed_len)
        Lr = max(Lr, fixed_len)
    q = np.zeros((lanes, Lq), dtype=np.uint8)
    r = np.zeros((lanes, Lr), dtype=np.uint8)
    ln = np.zeros((lanes, 2), dtype=np.int32)
    for i, (a, b) in enumerate(zip(qs, rs)):
        q[i, : len(a)] = a
        r[i, : len(b)] = b
        ln[i, 0] = len(a)
        ln[i, 1] = len(b)
    buf = np.concatenate(
        [pack_bases_host(q), pack_bases_host(r), ln.view(np.uint8)],
        axis=1,
    )
    fn = functools.partial(_spans_wire_body, Lq=Lq, Lr=Lr)
    key = ("stitch", per, Lq, Lr)
    parts = [run_call(dev, fn, buf[k * per : (k + 1) * per], graphs, key)
             for k, dev in enumerate(devs)]
    return (parts[0] if nd == 1 else graph_ops.Joined(parts)), n


def _collect(handle):
    pending, n = handle
    out = pending.result()
    return [
        AlignSpan(int(out[i, 0]), int(out[i, 1]), int(out[i, 2]),
                  int(out[i, 3]), bool(out[i, 4]))
        for i in range(n)
    ]
