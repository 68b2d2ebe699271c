#!/usr/bin/env python3
"""On-card smoke test of consent_tpu_torch, the PyTorch / CUDA port.

Needs one CUDA card and the repository checkout (it imports
consent_tpu_torch from beside this file; it imports neither jax nor
consent_tpu).  Phases, each failing the run by raising:

  1. setup: the card's name and power limit, torch / CUDA versions;
     builds both kernels (nvcc, in parallel) and the host library.
  2. the banded kernel against its plain PyTorch version at the main
     path's shapes: N = 4,096 (B = 256 windows x S = 16 slots) and the
     warm round's N = 1,280, and polish's deep 152-slot bucket, N = 3,952
     (B = 26 x S = 152) and its warm round's 988; q 512 x r 640, band
     128, random bases past each query's end.  Exact equality of all six outputs, then
     CUDA-event timings.  Then few-lane cases of the kernel's other code
     paths: bands 32, 64 and 256, exact gaps, N = 1,279.
  3. the full-width kernel against its plain version at the lane
     counts the stitch launches: N = 256 (the timed shape), 64, polish's
     32, and N = 1,024 for continuity with earlier runs, 640 x 640, stitch
     scoring, random bases past each query's end.  Then 16 lanes at
     widths 768, 896, 1,000 and 1,024 (the one-warp-per-lane kernel's
     widest instantiations), and at 1,152 to 4,096 or with a gap cap of
     16 (the one-block-per-lane kernel).  Same checks.
  4. repairs: the banded kernel at bands 384, 640, 768 and 896, and at
     1,152 (W = 1,280, the tiled design), and the full-width kernel at
     W = 4,224 and 8,192 (64 lanes), 16,384 and 16,512 (2 lanes, the
     tiled design; hm scratch in lane chunks), all six outputs equal to
     the plain version's; kernel ms and lane-chunk counts.
  5. graphs: every consensus call shape of correct_preset() (12, the
     deep 152-slot bucket's among them) and the stitch's span call at
     N = 16, 256 and 1,024 captured as CUDA graphs, the graph memory
     poisoned, then each replay byte-equal to the eager call on seeded
     inputs and counted in the launch counters; one consensus call
     (B = 256, S = 16, 2 rounds) timed eager against graph in turns.
     Then one whole consensus device call timed as before (eager).
  6. the main path, with graphs: process_piles on the card against the
     CPU path on a small simulation (byte-identical), then
     `cli.main_correct` on the benchmarks/e2e_bench.py workload (3.35 Mb
     genome, 10x, 4 kb reads, 10% error, seed 7) with both kernels'
     launch counters reset just before and read just after (replays
     count), the graphs replayed, stage thread-seconds and the
     full-width kernel's launches by lane count; 600 reads scored
     against the truth as e2e_bench.py samples them, identity >= 0.98
     required; then a torch.profiler trace of one 1,024-read chunk
     gives the device's busy share and each kernel's device seconds,
     and the same chunk runs eager, graph, graph, eager (same bytes).
  7. polish: `cli.main_polish` on tests/test_cli.py's small draft on the
     card and on the CPU (byte-identical), and twice more on the card
     with --resume (byte-identical again); then the polish workload at
     full size (benchmarks/polish_bench.py's shape: the main phase's
     3.35 Mb genome cut into 86 contigs of >= 5 kb, a 1%-error draft,
     the main phase's 10x reads), launch counters reset just before,
     every contig scored, polished > draft and >= 0.99 required, both
     kernels launched, consensus graphs replayed; then deep piles (150
     kb at 100x in 6 contigs of 25 kb), which must launch the banded
     kernel from the 152-slot fragment bucket and polish above the
     draft.
  8. mesh (parallel/mesh.py), proven on shards of one card: (1)
     sharded_consensus_step at the correct shape (B = 256, S = 16, 2
     rounds, warm 0.25) over [cuda:0] x 4 at frag 1, 2 and 4 op by op,
     byte-equal to the one-device call; at frag 2 and 4 the captured
     frag call (each data row's chain of phase-A and phase-B graphs)
     from poisoned graph memory, byte-equal to the one-device and the
     op-by-op calls, then eager against graph in turns; the frag-4
     split and all-reduce timed; (2, inside the main phase) the
     profiled 1,024-read chunk through process_piles on [cuda:0] x 2
     (data axis, captured calls), and on every card when there are
     more, FASTA bytes equal to the one-device run's; (3) the deep-pile
     cell on [cuda:0] x 4 at frag 4 and with frag chosen automatically
     (device_lanes 128 < s_cap 152), with captured calls and op by op,
     bytes equal to the one-device run's.  Each run's launch counters
     are set to 0 just before it and read just after; wall, launches by
     lane count, replays by kind and by frag shard, and the banded
     kernel's eager launches (outside any capture) are printed; runs on
     captured calls must make no eager banded launch, and frag runs
     must replay graphs on every shard.
  9. a detail JSON line, one JSON line of per-kernel results, the card
     line, and the final {"ok": true, "device": ...} line.

Usage: python3 chip_smoke.py [--only PHASE,...]  (no option: every phase;
`--only mesh` runs parts 1 and 3, `--only main,mesh` adds part 2)
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks used for the bound: device memory 3.35 TB/s (NVIDIA
# data sheet); integer ALU issue 16.7 T instructions/s = 132 SMs x 64
# lanes x 1.98 GHz boost (Hopper architecture white paper).  Hopper's DPX
# instructions (VIADDMNMX: max(a + b, c); VIMNMX3: 3-way max; both with
# an optional max with 0) issue at that same 64 per clock per SM
# (probes/int_rate.py on the card, PERF.md), so an add-max pair or a
# 3-way max costs one ALU instruction.  Integer adds can also issue as
# IMAD on the FMA pipe beside the ALU (same probe), so they do not bound.
# The packed s16x2 forms issue at the same rate with two int16 lanes each
# (same probe); the full-width kernel's DP runs in them, two cells per
# instruction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def alu_per_cell(sc) -> int:
    """ALU-pipe instructions one DP cell needs over both passes, with DPX.

    Forward: base compare, F = max(h - open, f - extend) as one add-max
    (f - extend is an add), Ht = max(hm, F, 0), E and H together as
    max(gap max - (j*extend + open - extend), Ht), opt max: 5, plus the
    horizontal-gap max.  Backward: base compare, max(sub + bh_diag, F,
    0), F, E and H, the on-path compare: 5, plus the gap max.  The gap
    max is one running max per column when gaps are exact, and
    ceil(log3(window)) 3-way maxes when capped (3 for the 16-column
    window: 3, 9, 16 columns).  The adds (hm, f - extend, the gap-max
    input, hm + bh_diag) can issue on the FMA pipe."""
    if not sc.max_hgap:
        return 2 * (5 + 1)
    window = 1 << math.ceil(math.log2(sc.max_hgap))
    return 2 * (5 + math.ceil(math.log(window, 3) - 1e-9))

REPLACES = {
    "banded_posterior": "consent_tpu/ops/pallas_align.py:229 (_kernel_banded)",
    "full_posterior": "consent_tpu/ops/pallas_align.py:76 (_kernel)",
}

# benchmarks/e2e_bench.py's workload, not cut: a change to GENOME_LEN is
# a cut of the workload and is recorded in PERF.md
GENOME_LEN = 3_350_000
E2E = dict(coverage=10.0, read_len=4000, error_rate=0.10, seed=7)
# benchmarks/polish_bench.py's shape on the main phase's genome: 86
# contigs (the bundled assembly's count), a 1%-error draft, not cut
POLISH_CONTIGS = 86
POLISH_MIN_CONTIG = 5_000
POLISH_DRAFT_ERR = 0.01
# deep piles: 100x over 6 contigs of 25 kb, so windows fill the
# 152-slot fragment bucket (maxMSA 150 + the template)
DEEP = dict(genome_len=150_000, coverage=100.0, read_len=4000,
            error_rate=0.10, seed=11)
DEEP_CONTIGS = 6
# banded lanes of one call in the 152-slot bucket: 26 windows (the
# 4,096-lane budget) or the 16-window tail, times 152 slots
DEEP_LANES = (26 * 152, 16 * 152)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs


def walk_fragments(rng, r, d0, q_len, Lq, err=0.1):
    """Fragments copied from their template rows r at offset d0 with
    ~err substitutions and indels (each step consumes 0-2 bases)."""
    N, W = r.shape
    q = np.zeros((N, Lq), np.uint8)
    for n in range(N):
        step = rng.choice([0, 1, 2], size=Lq, p=[err / 3, 1 - 2 * err / 3,
                                                err / 3])
        src = np.clip(d0[n] + np.cumsum(step) - step[0], 0, W - 1)
        frag = r[n, src]
        sub = rng.random(Lq) < err / 3
        frag[sub] = (frag[sub] + 1 + rng.integers(0, 3, sub.sum())) % 4
        q[n, : q_len[n]] = frag[: q_len[n]]
    return q


def near_diagonal_lanes(rng, N, Lq, W, d0_lo=-40, d0_hi=100):
    """Lanes shaped like the aligners' data: near-diagonal fragments of
    ragged length, plus empty and degenerate lanes."""
    r = rng.integers(0, 4, (N, W)).astype(np.uint8)
    r_len = rng.integers(W - 140, W + 1, N).astype(np.int32)
    d0 = rng.integers(d0_lo, d0_hi, N).astype(np.int32)
    q_len = rng.integers(Lq // 2, Lq + 1, N).astype(np.int32)
    q_len[5] = Lq                             # a full query row
    q = walk_fragments(rng, r, d0, q_len, Lq)
    # degenerate lanes: empty query, one base, empty template, offsets
    # past either end of the template
    q_len[0] = 0
    q_len[1] = 1
    r_len[2] = 0
    d0[3] = W + 7
    d0[4] = -W
    return q, q_len, r, r_len, d0


# ---------------------------------------------------------------- timing


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_vs_plain(name, q, q_len, r, r_len, d0, sc, reps, plain_reps=1):
    """Exact equality of the kernel and its plain version on the card,
    then both timed (the plain version over plain_reps calls after a
    warm-up; plain_reps = 0 times the comparison's own call); returns
    a result dict."""
    import torch

    from consent_tpu_torch.ops import align as align_ops
    from consent_tpu_torch.ops import cuda_align

    dev = torch.device("cuda")
    t = [torch.from_numpy(x).to(dev) for x in (q, q_len, r, r_len, d0)]
    if name == "banded_posterior":
        def kernel():
            return cuda_align.banded_posterior_summary(*t, sc)
    else:
        def kernel():
            return cuda_align.full_posterior_summary(*t[:4], sc)

    def plain():
        return align_ops.posterior_summary(
            *t[:4], sc, d0=t[4] if sc.band else None)

    got = kernel()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain()
    t1.record()
    torch.cuda.synchronize()
    max_err = 0
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}.{field}: {a.dtype}{tuple(a.shape)}"
                                 f" vs {b.dtype}{tuple(b.shape)}")
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
        max_err = max(max_err, diff)
        if diff:
            raise AssertionError(
                f"{name}.{field} differs from the plain version "
                f"({int((a != b).sum())} elements, max |diff| {diff})")
    matched_frac = want.matched.float().mean().item()
    kernel_ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps) if plain_reps else t0.elapsed_time(t1)

    N, Lq = q.shape
    W = r.shape[1]
    width = sc.band if sc.band else None
    rows = np.minimum(q_len, Lq).astype(np.int64)
    if width:
        cells = int(rows.sum()) * width
    else:
        cells = int((rows * np.minimum(r_len, W)).sum())
    ops = alu_per_cell(sc) * cells
    if name == "full_posterior" and W <= 1024 and not sc.max_hgap:
        ops //= 2     # the warp kernel: two int16 cells per s16x2 instruction
    in_bytes = q.nbytes + r.nbytes + q_len.nbytes + r_len.nbytes + (
        d0.nbytes if sc.band else 0)
    out_bytes = 4 * N + N * W * (1 + 4 * 4)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return dict(
        name=name, N=N, Lq=Lq, W=W, band=sc.band, max_hgap=sc.max_hgap,
        equal=True, max_abs_err=max_err, matched_frac=matched_frac,
        kernel_ms=kernel_ms, plain_ms=plain_ms, cells=cells,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
    )


# ---------------------------------------------------------------- phases


def phase_setup():
    import torch

    from consent_tpu_torch import native
    from consent_tpu_torch.ops import cuda_align

    card = card_line()
    log(f"[setup] card: {card}")
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = [pool.submit(cuda_align.build, k) for k in cuda_align.KERNELS]
        futs.append(pool.submit(native.get_lib))
        for f in futs:
            f.result()
    build_s = time.perf_counter() - t0
    log(f"[setup] kernels + host library built in {build_s:.3f} s")
    return card, build_s


def banded_lanes(rng, N):
    """Main-path banded lanes (q 512 x r 640) with random bases written
    at and past each query's end, which the kernel must never read."""
    q, q_len, r, r_len, d0 = near_diagonal_lanes(rng, N, 512, 640)
    tail = np.arange(q.shape[1])[None, :] >= q_len[:, None]
    q[tail] = rng.integers(0, 4, int(tail.sum()))
    return q, q_len, r, r_len, d0


def phase_banded(rng):
    """The main path's two shapes (N = 4,096 and the warm round's 1,280),
    the polish path's deep 152-slot bucket (N = 3,952 and its warm
    round's 988), then few-lane exact-equality cases for every code path of the
    kernel: bands 32, 64 and 256 (1, 2 and 8 slots per thread), exact
    gaps (the warp-wide scan), and an N that leaves the last block's
    warps partly idle.  Every case holds lanes with q_len = 0, 1 and Lq."""
    from consent_tpu_torch.ops.align import Scoring
    from consent_tpu_torch.config import correct_preset

    cfg = correct_preset()
    sc = Scoring(cfg.match_score, cfg.mismatch_score, cfg.gap_open,
                 cfg.gap_extend, cfg.consensus_max_hgap, cfg.consensus_band)
    out = []
    for N in (4096, 1280, 3952, 988):
        res = kernel_vs_plain("banded_posterior", *banded_lanes(rng, N), sc,
                              reps=20)
        log(f"[banded] N={N}: equal; kernel {res['kernel_ms']:.3f} ms, "
            f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms"
            f" ({res['bound_by']}), matched {res['matched_frac']:.3f}")
        out.append(res)
    cases = []
    for N, band, gap in ((16, 32, 16), (16, 64, 16), (16, 256, 16),
                         (16, 32, 0), (16, 128, 0), (1279, 128, 16)):
        res = kernel_vs_plain("banded_posterior", *banded_lanes(rng, N),
                              sc._replace(band=band, max_hgap=gap), reps=2)
        log(f"[banded] N={N}, band {band}, max_hgap {gap}: equal; kernel "
            f"{res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"matched {res['matched_frac']:.3f}")
        cases.append({k: res[k] for k in ("N", "band", "max_hgap", "equal",
                                          "kernel_ms", "plain_ms",
                                          "matched_frac")})
    return out, cases


def phase_consensus_call(rng):
    """One full consensus device call of the main path (B = 256
    windows x S = 16 slots, 2 rounds, warm 0.25, assembled output),
    timed with CUDA events: the banded kernel's share of the call."""
    import torch

    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.ops import consensus as cons_ops
    from consent_tpu_torch.pipeline.engine import ConsensusEngine

    cfg = correct_preset()
    eng = ConsensusEngine(cfg, device="cuda")
    B, S, Lf, Lt = 256, 16, eng.Lf, eng.Lt
    tpl = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    tpl_len = rng.integers(cfg.window_size, Lt - 20, B).astype(np.int32)
    frag_len = rng.integers(Lf - 60, Lf + 1, (B, S)).astype(np.int32)
    frag_len[:, 12:] = 0                      # ragged piles
    d0 = rng.integers(-10, 10, (B, S)).astype(np.int32)
    frags = walk_fragments(rng, np.repeat(tpl, S, axis=0), d0.reshape(-1),
                           frag_len.reshape(-1), Lf).reshape(B, S, Lf)
    frags[:, 0] = tpl[:, :Lf]                 # template first
    buf = torch.from_numpy(cons_ops.wire_encode_inputs(
        cons_ops.pack_bases_host(frags), frag_len, tpl, tpl_len, d0)).cuda()

    def call():
        return cons_ops.consensus_votes_wire(
            buf, S=S, Pb=Lf // 4, Lt=Lt,
            min_column_support=cfg.min_column_support, scoring=eng.scoring,
            rounds=cfg.consensus_rounds, assemble_out=True,
            warm_frac=cfg.warm_frac)

    call_ms = cuda_ms(call, 5)
    log(f"[consensus] one consensus_votes_wire call (B={B}, S={S}, "
        f"{cfg.consensus_rounds} rounds): {call_ms:.3f} ms")
    return dict(B=B, S=S, rounds=cfg.consensus_rounds, call_ms=call_ms)


def full_lanes(rng, N, W):
    """Stitch-shaped lanes (q and template W wide, W = 640 on the main
    path) with random bases written at and past each query's end, which
    the kernel must never read; lanes 0, 1 and 5 have q_len 0, 1 and W,
    lane 2 an empty template."""
    q, q_len, r, r_len, d0 = near_diagonal_lanes(rng, N, W, W, d0_lo=0,
                                                 d0_hi=60)
    tail = np.arange(W)[None, :] >= q_len[:, None]
    q[tail] = rng.integers(0, 4, int(tail.sum()))
    return q, q_len, r, r_len, d0


def phase_full(rng):
    """The full-width kernel at the main path's lane counts: each stitch
    call carries a chunk group's jobs padded to a power of two, mostly
    256 lanes (pipeline/stitch.py, pipeline/device_align.py), down to 16;
    polish's 86 contigs in 4 groups give 32 lanes; N = 1,024 is kept for
    continuity with earlier runs.  Returns the results by N."""
    from consent_tpu_torch.pipeline.device_align import _SCORING

    out = {}
    for N, reps in ((256, 20), (64, 20), (1024, 5), (32, 20)):
        res = kernel_vs_plain("full_posterior", *full_lanes(rng, N, 640),
                              _SCORING, reps=reps)
        log(f"[full] N={N}: equal; kernel {res['kernel_ms']:.3f} ms, "
            f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms"
            f" ({res['bound_by']}), matched {res['matched_frac']:.3f}")
        out[N] = res
    return out


def phase_full_widths(rng):
    """The full-width kernel against its plain version at the stitch's
    other widths (768, 896 and 1,024 columns: 24, 28 and 32 columns per
    thread of the one-warp-per-lane kernel), at a width that leaves
    columns of the last thread idle (1,000), past 1,024 columns (the
    one-block-per-lane kernel, 2 and 4 columns per thread), and with the
    gap cap of the consensus aligner when its band is 0.  Exact
    equality; few lanes, so the plain version's row loop stays short."""
    from consent_tpu_torch.ops.align import Scoring
    from consent_tpu_torch.pipeline.device_align import _SCORING

    capped = Scoring(2, -4, 4, 2, max_hgap=16, band=0)
    out = []
    for W, sc in ((768, _SCORING), (896, _SCORING), (1024, _SCORING),
                  (896, capped), (1000, _SCORING), (1152, _SCORING),
                  (1152, capped), (2500, _SCORING), (4096, capped)):
        lanes = full_lanes(rng, 16, W)
        res = kernel_vs_plain("full_posterior", *lanes, sc, reps=2)
        log(f"[full] N=16, W={W}, max_hgap={sc.max_hgap}: equal; kernel "
            f"{res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"matched {res['matched_frac']:.3f}")
        out.append(dict(W=W, max_hgap=sc.max_hgap, kernel_ms=res["kernel_ms"],
                        plain_ms=res["plain_ms"],
                        matched_frac=res["matched_frac"]))
    return out


def phase_repairs(rng):
    """Shapes the port raised on before (ROADMAP Queue 3): the banded
    kernel at bands 384, 640, 768 and 896 (12 to 28 slots per thread;
    q 512, template 640, or 1,024 where the band exceeds 640) and at
    band 1,152 (W = 1,280: the tiled design), and the full-width kernel
    at W = 4,224 and 8,192 (64 lanes) and 16,384 (2 lanes), exact gaps,
    stitch scoring, one block per lane with 8 and 16 columns per thread,
    and at W = 16,512 (2 lanes: the tiled design), hm scratch in lane
    chunks.  All six outputs equal to the plain version's (tolerance
    0)."""
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.ops.align import Scoring
    from consent_tpu_torch.pipeline.device_align import _SCORING

    cfg = correct_preset()
    sc = Scoring(cfg.match_score, cfg.mismatch_score, cfg.gap_open,
                 cfg.gap_extend, cfg.consensus_max_hgap, cfg.consensus_band)
    bands = []
    for band in (384, 640, 768, 896, 1152):
        W = 640 if band <= 640 else (1024 if band <= 1024 else 1280)
        q, q_len, r, r_len, d0 = near_diagonal_lanes(rng, 256, 512, W)
        tail = np.arange(512)[None, :] >= q_len[:, None]
        q[tail] = rng.integers(0, 4, int(tail.sum()))
        res = kernel_vs_plain("banded_posterior", q, q_len, r, r_len, d0,
                              sc._replace(band=band), reps=5)
        variant = cuda_align.banded_variant(band, W)
        log(f"[repair] banded N=256, band {band}, W={W} ({variant}): equal; "
            f"kernel {res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.3f} "
            f"ms, bound {res['bound_ms']:.3f} ms, matched "
            f"{res['matched_frac']:.3f}")
        bands.append({"variant": variant, **{k: res[k] for k in (
                                          "N", "W", "band", "kernel_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "matched_frac")}})
    widths = []
    for N, W in ((64, 4224), (64, 8192), (2, 16384), (2, 16512)):
        if N >= 6:
            q, q_len, r, r_len, d0 = full_lanes(rng, N, W)
        else:
            # a full query row, and one half as long at an offset; random
            # bases past each query's end
            r = rng.integers(0, 4, (N, W)).astype(np.uint8)
            r_len = np.full(N, W, np.int32)
            d0 = np.array([0] + [W // 4] * (N - 1), np.int32)
            q_len = np.array([W] + [W // 2] * (N - 1), np.int32)
            q = walk_fragments(rng, r, d0, q_len, W)
            tail = np.arange(W)[None, :] >= q_len[:, None]
            q[tail] = rng.integers(0, 4, int(tail.sum()))
        res = kernel_vs_plain("full_posterior", q, q_len, r, r_len, d0,
                              _SCORING, reps=2, plain_reps=0)
        chunks = len(cuda_align.full_lane_chunks(N, W, W))
        variant = cuda_align.full_variant(W, _SCORING)
        log(f"[repair] full N={N}, W={W} ({variant}): equal; kernel "
            f"{res['kernel_ms']:.3f} ms in {chunks} lane chunk(s), plain "
            f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
            f"({res['bound_by']}), matched {res['matched_frac']:.3f}")
        widths.append(dict(N=N, W=W, lane_chunks=chunks, variant=variant,
                           **{k: res[k] for k in ("kernel_ms", "plain_ms",
                                                  "bound_ms", "bound_by",
                                                  "matched_frac")}))
    return dict(bands=bands, widths=widths)


def poison_graph_memory(dev, byte=0xA5):
    """Every byte of the device's graph pool and of every captured
    call's static tensors (its input; a frag chain's every buffer kept
    from one replay to the next) set to `byte`: a replay that read
    memory no kernel of its call wrote would now change its output."""
    import torch

    from consent_tpu_torch.ops import graphs as graph_ops

    torch.cuda.synchronize()
    total = 0
    for addr, n in graph_ops.pool_segments(dev):
        storage = torch._C._construct_storage_from_data_pointer(addr, dev, n)
        torch.empty(0, dtype=torch.uint8, device=dev).set_(storage).fill_(byte)
        total += n
    for call in graph_ops.calls().values():
        # a frag chain's static partials, sums, templates and output too
        for t in call.static_tensors():
            t.view(torch.uint8).fill_(byte)
    torch.cuda.synchronize()
    return total


def consensus_arrays(rng, eng, B, S):
    """Seeded inputs of one consensus call, B windows x S slots:
    fragments walked off each window's template at small offsets,
    ragged piles; (2-bit packed fragments, frag_len, tpl, tpl_len, d0)."""
    from consent_tpu_torch.ops import consensus as cons_ops

    cfg, Lf, Lt = eng.cfg, eng.Lf, eng.Lt
    tpl = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    tpl_len = rng.integers(cfg.window_size, Lt - 20, B).astype(np.int32)
    frag_len = rng.integers(Lf - 60, Lf + 1, (B, S)).astype(np.int32)
    frag_len[:, max(1, 3 * S // 4):] = 0                  # ragged piles
    frag_len[-1, 1:] = 0                                  # a lone template
    d0 = rng.integers(-10, 10, (B, S)).astype(np.int32)
    frags = walk_fragments(rng, np.repeat(tpl, S, axis=0), d0.reshape(-1),
                           frag_len.reshape(-1), Lf).reshape(B, S, Lf)
    frags[:, 0] = tpl[:, :Lf]                             # template first
    frag_len[:, 0] = np.minimum(tpl_len, Lf)
    return cons_ops.pack_bases_host(frags), frag_len, tpl, tpl_len, d0


def consensus_inputs(rng, eng, B, S):
    """One seeded wire buffer of B windows x S slots (consensus_arrays)."""
    from consent_tpu_torch.ops import consensus as cons_ops

    return cons_ops.wire_encode_inputs(*consensus_arrays(rng, eng, B, S))


def stitch_inputs(rng, N, L):
    """One seeded span-call buffer of N lanes at L x L, the last quarter
    padding lanes (q_len = r_len = 0), as the stitch pads to a power of
    two."""
    from consent_tpu_torch.ops.consensus import pack_bases_host

    q, q_len, r, r_len, _ = full_lanes(rng, N, L)
    pad = N - N // 4
    q_len[pad:] = 0
    r_len[pad:] = 0
    q[pad:] = 0
    r[pad:] = 0
    q[np.arange(L)[None, :] >= q_len[:, None]] = 0
    r[np.arange(L)[None, :] >= r_len[:, None]] = 0
    ln = np.stack([q_len, r_len], axis=1).astype(np.int32)
    return np.concatenate([pack_bases_host(q), pack_bases_host(r),
                           ln.view(np.uint8)], axis=1)


def wall_ms(fn, reps):
    """Host milliseconds per call of fn (each waits for its result)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_graphs(rng):
    """Every consensus call shape of correct_preset() (the 12 keys of
    ConsensusEngine.call_shapes(), the deep 152-slot bucket's among
    them) and the stitch's span call at N = 16, 256 and 1,024 (640 x
    640) captured, the graph memory poisoned, then each replayed against
    the eager call on the same seeded input: byte-equal outputs, and
    every replay adds its graph's launches to the counts.  Then one
    consensus call (B = 256, S = 16), eager against graph, in turns."""
    import functools

    import torch

    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.ops import graphs as graph_ops
    from consent_tpu_torch.pipeline import device_align
    from consent_tpu_torch.pipeline.engine import ConsensusEngine

    dev = torch.device("cuda", 0)
    cfg = correct_preset()
    t0 = time.perf_counter()
    eng = ConsensusEngine(cfg, device=dev)
    cons_capture_s = time.perf_counter() - t0
    shapes = sorted(eng.call_shapes())
    stitch = {}
    t0 = time.perf_counter()
    for N in (16, 256, 1024):
        fn = functools.partial(device_align._spans_wire_body, Lq=640, Lr=640)
        stitch[N] = (fn, graph_ops.captured(("stitch", N, 640, 640), fn,
                                            (N, 2 * 640 // 4 + 8), dev))
    stitch_capture_s = time.perf_counter() - t0
    poisoned = poison_graph_memory(dev)
    log(f"[graphs] captured {len(shapes)} consensus shapes in "
        f"{cons_capture_s:.3f} s and 3 stitch shapes in "
        f"{stitch_capture_s:.3f} s; poisoned {poisoned} bytes of graph "
        f"memory")

    def check(tag, call, eager_fn, buf):
        before = sum(cuda_align.launch_counts().values())
        got = call(buf).result()
        added = sum(cuda_align.launch_counts().values()) - before
        want = graph_ops.run_eager(eager_fn, buf, dev).result()
        if got.dtype != want.dtype or got.shape != want.shape or \
                not np.array_equal(got, want):
            raise AssertionError(f"[graphs] {tag}: replay differs from the "
                                 f"eager call")
        if not call.launches or added != len(call.launches):
            raise AssertionError(f"[graphs] {tag}: replay counted {added} "
                                 f"launches, recorded {call.launches}")

    for S, B in shapes:
        call = eng._captured(S, B, eng.rounds)
        check(f"consensus S={S} B={B}", call, eng._wire_fn(S, eng.rounds),
              consensus_inputs(rng, eng, B, S))
    for N, (fn, call) in stitch.items():
        check(f"stitch N={N}", call, fn, stitch_inputs(rng, N, 640))
    log(f"[graphs] {len(shapes)} consensus and {len(stitch)} stitch replays "
        f"byte-equal to the eager calls from poisoned memory")

    # one consensus call, eager against graph, in turns
    buf = consensus_inputs(rng, eng, 256, 16)
    call = eng._captured(16, 256, eng.rounds)
    fn = eng._wire_fn(16, eng.rounds)
    turns = []
    for mode in ("eager", "graph", "graph", "eager"):
        if mode == "graph":
            ms = wall_ms(lambda: call(buf).result(), 20)
        else:
            ms = wall_ms(lambda: graph_ops.run_eager(fn, buf, dev).result(), 20)
        turns.append((mode, ms))
    eager_ms = [ms for m, ms in turns if m == "eager"]
    graph_ms = [ms for m, ms in turns if m == "graph"]
    st = graph_ops.stats()
    log(f"[graphs] one consensus call (B=256, S=16, {eng.rounds} rounds, "
        f"upload and download included), in turns: "
        + ", ".join(f"{m} {ms:.3f} ms" for m, ms in turns)
        + f"; {st['graphs']} graphs, pool {st['pool_bytes']} bytes, "
        f"capture {st['capture_s']:.3f} s")
    return dict(consensus_shapes=shapes, stitch_lanes=sorted(stitch),
                consensus_capture_s=cons_capture_s,
                stitch_capture_s=stitch_capture_s, poisoned_bytes=poisoned,
                call_turns=turns, call_eager_ms=eager_ms,
                call_graph_ms=graph_ms, graphs=st["graphs"],
                pool_bytes=st["pool_bytes"])


def phase_card_vs_cpu():
    """process_piles on the card and on the CPU (plain versions) on a
    small simulation must give the same bytes."""
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.pipeline import engine
    from consent_tpu_torch.testing import simulate

    genome, reads = simulate.simulate(genome_len=3000, coverage=14.0,
                                      read_len=900, error_rate=0.10, seed=42)
    cfg = correct_preset(window_size=200, window_overlap=20, min_support=3)
    index = ReadIndex()
    for rd in reads:
        index.add(rd.name, rd.codes)
    piles = simulate.piles_from_sim(reads, cfg.max_support)[:3]
    t0 = time.perf_counter()
    card = list(engine.process_piles(iter(piles), index, cfg, device="cuda"))
    cpu = list(engine.process_piles(iter(piles), index, cfg, device="cpu"))
    for (n1, c1, s1), (n2, c2, s2) in zip(card, cpu):
        if n1 != n2 or not np.array_equal(c1, c2) or not np.array_equal(s1, s2):
            raise AssertionError(f"card and CPU paths differ on read {n1}")
    if len(card) != len(cpu) or not any(len(c) for _, c, _ in card):
        raise AssertionError("card vs CPU check produced no reads")
    log(f"[main] card == CPU on {len(piles)} piles "
        f"({time.perf_counter() - t0:.1f} s)")


def write_fasta(path, records):
    from consent_tpu_torch.io import seqs

    with open(path, "w") as f:
        for name, codes in records:
            f.write(f">{name}\n{seqs.decode(codes)}\n")


def simulate_reads(workdir, tag, **sim):
    """(genome, reads, reads FASTA path) of one simulation."""
    from consent_tpu_torch.testing import simulate

    t0 = time.perf_counter()
    genome, reads = simulate.simulate(**sim)
    reads_fa = os.path.join(workdir, f"{tag}_reads.fasta")
    write_fasta(reads_fa, ((rd.name, rd.codes) for rd in reads))
    n_bases = int(sum(len(rd.codes) for rd in reads))
    log(f"[{tag}] simulated {len(reads)} reads, {n_bases / 1e6:.3f} Mb "
        f"({time.perf_counter() - t0:.1f} s, excluded)")
    return genome, reads, reads_fa


def score_pool(pairs):
    """metrics.identity over (test, truth) pairs in a process pool, the
    longest first; returns the identities in the pairs' order."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from consent_tpu_torch.testing import metrics

    order = sorted(range(len(pairs)), key=lambda i: -len(pairs[i][1]))
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 1,
                             mp_context=mp.get_context("spawn")) as pool:
        ids = list(pool.map(metrics.identity,
                            *zip(*(pairs[i] for i in order))))
    out = [0.0] * len(pairs)
    for i, v in zip(order, ids):
        out[i] = v
    return out


def phase_main(genome, reads, reads_fa, workdir, mesh=False):
    from consent_tpu_torch import cli
    from consent_tpu_torch.io import seqs
    from consent_tpu_torch.io.fasta import iter_fastx
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.ops import graphs as graph_ops
    from consent_tpu_torch.overlap import minimizer as mz
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.utils.observe import GLOBAL_STATS

    # overlap stage on its own (materialized), as e2e_bench.py times it
    t0 = time.perf_counter()
    named = [(rd.name, rd.codes) for rd in reads]
    piles = list(mz.all_vs_all_piles(
        named, mz.OverlapParams(), correct_preset().max_support))
    overlap_s = time.perf_counter() - t0
    log(f"[main] overlap: {len(piles)} piles in {overlap_s:.3f} s")

    out_fa = os.path.join(workdir, "corrected.fasta")
    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()
    graphs_before = graph_ops.stats()["by_kind"]
    cuda_align.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main_correct(["--in", reads_fa, "--out", out_fa,
                           "--overlapper", "native", "--stats"])
    correct_s = time.perf_counter() - t0
    launches = cuda_align.launch_counts()
    lane_hist = cuda_align.lane_histogram()
    if rc != 0:
        raise AssertionError(f"main_correct returned {rc}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    graphs = graph_delta(graphs_before)
    if not graphs.get("consensus", {}).get("replays"):
        raise AssertionError(f"main_correct replayed no consensus graph: "
                             f"{graphs}")
    stats = GLOBAL_STATS.snapshot()
    n_windows = stats["counts"].get("windows.total", 0)
    pipe_s = stats["seconds"].get("consent-correct.pipeline", correct_s)
    stage_s = {k: v for k, v in sorted(stats["seconds"].items())
               if k != "consent-correct.pipeline"}
    log(f"[main] main_correct {correct_s:.3f} s (streamed overlap + "
        f"pipeline {pipe_s:.3f} s), {n_windows} windows, "
        f"{n_windows / pipe_s:.2f} windows/s, launches {launches}")
    log(f"[main] graphs captured and replayed in main_correct: {graphs}")
    log(f"[main] stage thread-seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items()))
    log(f"[main] full_posterior launches by lane count: "
        f"{lane_hist['full_posterior']}")

    # accuracy on the e2e_bench.py sample: 600 reads of the output, in
    # output order, rng(0) without replacement
    by_name = {rd.name: rd for rd in reads}
    results = [(name, seqs.encode(s)) for name, s in iter_fastx(out_fa)]
    if not results:
        raise AssertionError("main_correct wrote no reads")
    sample = results
    if len(results) > 600:
        sel = np.random.default_rng(0).choice(len(results), 600,
                                              replace=False)
        sample = [results[i] for i in sorted(sel)]
    pairs = []
    for name, codes in sample:
        rd = by_name[name]
        truth = genome[rd.g_beg : rd.g_end]
        if rd.reverse:
            truth = seqs.revcomp(truth)
        pairs.append((codes, truth))
        pairs.append((rd.codes, truth))
    t0 = time.perf_counter()
    ids = score_pool(pairs)
    cor_id = float(np.mean(ids[0::2]))
    raw_id = float(np.mean(ids[1::2]))
    log(f"[main] identity raw {raw_id:.4f} -> corrected {cor_id:.4f} on "
        f"{len(sample)} reads ({time.perf_counter() - t0:.1f} s scoring)")
    if not cor_id >= 0.98:
        raise AssertionError(f"corrected identity {cor_id:.4f} < 0.98")
    from consent_tpu_torch.io.fasta import ReadIndex

    index = ReadIndex()
    for rd in reads:
        index.add(rd.name, rd.codes)
    chunk_cfg = correct_preset(n_workers=os.cpu_count())
    profile = phase_profile("main", piles[:1024], index, chunk_cfg)
    chunk_turns, chunk_out = eager_vs_graph(piles[:1024], index, chunk_cfg)
    mesh_res = (mesh_chunk(piles[:1024], index, chunk_cfg, chunk_out)
                if mesh else None)
    return dict(
        profile=profile, chunk_turns=chunk_turns, graphs=graphs,
        mesh_chunk=mesh_res,
        stage_thread_s=stage_s,
        genome_len=len(genome), n_reads=len(reads), n_out=len(results),
        n_windows=n_windows, overlap_wall_s=overlap_s,
        correct_wall_s=correct_s, pipeline_wall_s=pipe_s,
        windows_per_s=n_windows / pipe_s, raw_identity=raw_id,
        corrected_identity=cor_id, n_scored=len(sample),
        launches=launches, lane_histogram=lane_hist,
    )


def graph_delta(before):
    """Graphs captured and replays made, by kind, since `before`
    (graph_ops.stats()["by_kind"])."""
    from consent_tpu_torch.ops import graphs as graph_ops

    out = {}
    for kind, now in graph_ops.stats()["by_kind"].items():
        was = before.get(kind, dict(graphs=0, replays=0))
        out[kind] = {k: now[k] - was[k] for k in now}
    return out


def eager_vs_graph(piles, index, cfg):
    """process_piles over `piles` op by op against replayed graphs, in
    turns eager, graph, graph, eager: wall seconds, windows/s and stage
    thread-seconds of each; the outputs of all four must be the same
    bytes."""
    import torch

    from consent_tpu_torch.pipeline import engine
    from consent_tpu_torch.utils.observe import GLOBAL_STATS

    turns = []
    first = None
    for mode in ("eager", "graph", "graph", "eager"):
        GLOBAL_STATS.seconds.clear()
        GLOBAL_STATS.counts.clear()
        t0 = time.perf_counter()
        out = list(engine.process_piles(iter(piles), index, cfg,
                                        device="cuda",
                                        graphs=mode == "graph"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = GLOBAL_STATS.snapshot()
        n_windows = snap["counts"].get("windows.total", 0)
        dispatch = snap["seconds"].get("consensus.dispatch", 0.0)
        turns.append(dict(mode=mode, wall_s=wall, windows=n_windows,
                          windows_per_s=n_windows / wall,
                          dispatch_thread_s=dispatch,
                          stage_thread_s=dict(sorted(snap["seconds"].items()))))
        log(f"[main] {len(piles)} piles, {mode}: {wall:.3f} s, "
            f"{n_windows / wall:.2f} windows/s, consensus.dispatch "
            f"{dispatch:.3f} thread-s")
        if first is None:
            first = out
        elif any(a[0] != b[0] or not np.array_equal(a[1], b[1])
                 or not np.array_equal(a[2], b[2])
                 for a, b in zip(first, out)) or len(first) != len(out):
            raise AssertionError(f"[main] {mode} turn: output differs from "
                                 f"the first turn's")
    return turns, first


def run_polish(tag, contigs_fa, reads_fa, out_fa, extra=()):
    """cli.main_polish on the card with launch counters and stage stats
    reset just before; returns its measurements."""
    from consent_tpu_torch import cli
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.ops import graphs as graph_ops
    from consent_tpu_torch.utils.observe import GLOBAL_STATS

    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()
    graphs_before = graph_ops.stats()["by_kind"]
    cuda_align.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main_polish(["--contigs", contigs_fa, "--reads", reads_fa,
                          "--out", out_fa, "--overlapper", "native",
                          "--stats", *extra])
    wall_s = time.perf_counter() - t0
    launches = cuda_align.launch_counts()
    lane_hist = cuda_align.lane_histogram()
    graphs = graph_delta(graphs_before)
    if rc != 0:
        raise AssertionError(f"[{tag}] main_polish returned {rc}")
    if not graphs.get("consensus", {}).get("replays"):
        raise AssertionError(f"[{tag}] main_polish replayed no consensus "
                             f"graph: {graphs}")
    stats = GLOBAL_STATS.snapshot()
    n_windows = stats["counts"].get("windows.total", 0)
    pipe_s = stats["seconds"]["consent-polish.pipeline"]
    stage_s = {k: v for k, v in sorted(stats["seconds"].items())
               if k != "consent-polish.pipeline"}
    log(f"[{tag}] main_polish {wall_s:.3f} s (streamed overlap + pipeline "
        f"{pipe_s:.3f} s), {n_windows} windows, {n_windows / pipe_s:.2f} "
        f"windows/s, launches {launches}")
    log(f"[{tag}] stage thread-seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items()))
    for name, hist in lane_hist.items():
        log(f"[{tag}] {name} launches by lane count: {hist}")
    log(f"[{tag}] graphs captured and replayed: {graphs}")
    return dict(wall_s=wall_s, pipeline_wall_s=pipe_s, n_windows=n_windows,
                windows_per_s=n_windows / pipe_s, stage_thread_s=stage_s,
                launches=launches, lane_histogram=lane_hist, graphs=graphs)


def score_polish(tag, out_fa, truth, draft):
    """Mean identity over the contigs of the polished output and of the
    draft, each against its truth, as benchmarks/polish_bench.py scores."""
    from consent_tpu_torch.io import seqs
    from consent_tpu_torch.io.fasta import iter_fastx

    polished = {n: seqs.encode(s) for n, s in iter_fastx(out_fa)}
    if sorted(polished) != sorted(truth):
        raise AssertionError(f"[{tag}] polished {len(polished)} of "
                             f"{len(truth)} contigs")
    t0 = time.perf_counter()
    pairs = [(polished[n], truth[n]) for n in truth]
    pairs += [(draft[n], truth[n]) for n in truth]
    ids = score_pool(pairs)
    n = len(truth)
    pol_id, draft_id = float(np.mean(ids[:n])), float(np.mean(ids[n:]))
    log(f"[{tag}] identity draft {draft_id:.5f} -> polished {pol_id:.5f} "
        f"over {n} contigs ({time.perf_counter() - t0:.1f} s scoring)")
    if not pol_id > draft_id:
        raise AssertionError(f"[{tag}] polished {pol_id:.5f} <= draft "
                             f"{draft_id:.5f}")
    return dict(draft_identity=draft_id, polished_identity=pol_id,
                n_contigs=n)


def cut_contigs(genome, n, min_len, rng, draft_err):
    """The genome cut at n - 1 points drawn from rng into contigs of at
    least min_len bases, and a draft of each mutated by rng at
    draft_err: (truth, draft) dicts by contig name."""
    from consent_tpu_torch.testing import simulate

    slack = len(genome) - n * min_len
    pts = np.sort(rng.integers(0, slack + 1, n - 1))
    cuts = np.concatenate([[0], pts + min_len * np.arange(1, n),
                           [len(genome)]])
    truth = {f"contig{i}": genome[cuts[i]: cuts[i + 1]] for i in range(n)}
    draft = {name: simulate.mutate(c, rng, draft_err)[0]
             for name, c in truth.items()}
    return truth, draft


def phase_polish_card_vs_cpu(workdir):
    """main_polish on tests/test_cli.py's small draft: the card and the
    CPU write the same bytes, and so do two card runs with --resume.
    The first card run writes a --profile-dir trace, which must hold
    the banded kernel's launches (one contig's stitch goes to the host
    aligner)."""
    from consent_tpu_torch import cli
    from consent_tpu_torch.testing import simulate

    genome, reads = simulate.simulate(genome_len=2000, coverage=10.0,
                                      read_len=700, error_rate=0.08, seed=21)
    reads_fa = os.path.join(workdir, "small_reads.fasta")
    write_fasta(reads_fa, ((rd.name, rd.codes) for rd in reads))
    asm_fa = os.path.join(workdir, "small_draft.fasta")
    write_fasta(asm_fa, [("contig1", simulate.mutate(
        genome, np.random.default_rng(1), 0.02)[0])])
    base = ["--contigs", asm_fa, "--reads", reads_fa, "--windowSize", "200",
            "--windowOverlap", "20", "--overlapper", "native"]
    trace_dir = os.path.join(workdir, "trace")
    t0 = time.perf_counter()
    outs = {}
    # both --resume runs write one output: the second resumes the first
    for tag, out, extra in (("cuda", "card", ["--profile-dir", trace_dir]),
                            ("cpu", "cpu", ["--device", "cpu"]),
                            ("resume1", "resumed", ["--resume"]),
                            ("resume2", "resumed", ["--resume"])):
        path = os.path.join(workdir, f"small_{out}.fasta")
        if cli.main_polish(base + ["--out", path] + extra) != 0:
            raise AssertionError(f"[polish] small draft, {tag}: rc != 0")
        with open(path, "rb") as f:
            outs[tag] = f.read()
    if not outs["cuda"].startswith(b">contig1\n") or len(outs["cuda"]) < 1900:
        raise AssertionError("[polish] small draft: no polished contig")
    for tag in ("cpu", "resume1", "resume2"):
        if outs[tag] != outs["cuda"]:
            raise AssertionError(f"[polish] small draft: {tag} bytes differ "
                                 f"from the card's")
    (trace,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    if not any(re.search(r"\bbanded_posterior(_\w+)?_kernel<", n)
               for n in names):
        raise AssertionError("[polish] the --profile-dir trace has no "
                             "banded_posterior kernel")
    log(f"[polish] small draft: card == CPU == card --resume (twice), "
        f"{len(outs['cuda'])} bytes, {len(names)} kernel names in the "
        f"--profile-dir trace ({time.perf_counter() - t0:.1f} s)")


def phase_polish(genome, reads_fa, workdir):
    """The polish workload at full size on the main phase's genome and
    reads (benchmarks/polish_bench.py's gate: polished > draft and
    >= 0.99); both kernels must launch."""
    t0 = time.perf_counter()
    truth, draft = cut_contigs(genome, POLISH_CONTIGS, POLISH_MIN_CONTIG,
                               np.random.default_rng(3), POLISH_DRAFT_ERR)
    lens = np.array([len(c) for c in truth.values()])
    asm_fa = os.path.join(workdir, "draft.fasta")
    write_fasta(asm_fa, draft.items())
    log(f"[polish] {len(truth)} contigs, lengths min {lens.min()}, median "
        f"{int(np.median(lens))}, max {lens.max()} "
        f"({time.perf_counter() - t0:.1f} s, excluded)")
    out_fa = os.path.join(workdir, "polished.fasta")
    res = run_polish("polish", asm_fa, reads_fa, out_fa)
    for name, n in res["launches"].items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"polish path")
    res.update(score_polish("polish", out_fa, truth, draft))
    if not res["polished_identity"] >= 0.99:
        raise AssertionError(f"[polish] polished identity "
                             f"{res['polished_identity']:.5f} < 0.99")
    res["contig_len"] = dict(min=int(lens.min()), median=float(np.median(lens)),
                             max=int(lens.max()))

    # the overlap stage on its own (reads mapped onto the draft,
    # materialized), then the device's busy share over the pipeline
    from consent_tpu_torch.config import polish_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.overlap import minimizer as mz

    index = ReadIndex()
    for name, codes in draft.items():
        index.add(name, codes)
    reads = ReadIndex.from_file(reads_fa)
    read_list = [(n, reads[n]) for n in reads.names()]
    for name, codes in read_list:
        index.add(name, codes)
    cfg = polish_preset(n_workers=os.cpu_count())
    t0 = time.perf_counter()
    piles = list(mz.map_to_targets_piles(list(draft.items()), read_list,
                                         mz.OverlapParams(), cfg.max_support))
    res["overlap_wall_s"] = time.perf_counter() - t0
    log(f"[polish] overlap: {len(piles)} piles in "
        f"{res['overlap_wall_s']:.3f} s")
    res["profile"] = phase_profile("polish", piles, index, cfg)
    return res


def deep_inputs(workdir):
    """The deep-pile cell's data: (truth, draft, draft FASTA, reads
    FASTA)."""
    genome, _, reads_fa = simulate_reads(workdir, "deep", **DEEP)
    truth, draft = cut_contigs(genome, DEEP_CONTIGS,
                               len(genome) // DEEP_CONTIGS,
                               np.random.default_rng(3), POLISH_DRAFT_ERR)
    asm_fa = os.path.join(workdir, "deep_draft.fasta")
    write_fasta(asm_fa, draft.items())
    return truth, draft, asm_fa, reads_fa


def phase_polish_deep(workdir, deep):
    """Deep piles: 100x reads over contigs of 25 kb fill the 152-slot
    fragment bucket; the banded kernel must launch from it and the
    polished contigs must beat the draft."""
    truth, draft, asm_fa, reads_fa = deep
    out_fa = os.path.join(workdir, "deep_polished.fasta")
    res = run_polish("deep", asm_fa, reads_fa, out_fa)
    hist = res["lane_histogram"]["banded_posterior"]
    deep_n = {n: hist.get(n, 0) for n in DEEP_LANES}
    if not sum(deep_n.values()):
        raise AssertionError(f"[deep] no banded launch from the 152-slot "
                             f"bucket: {hist}")
    res.update(score_polish("deep", out_fa, truth, draft))
    return res


# ---------------------------------------------------------------- mesh
#
# The mesh is proven on shards of one card: a device list may repeat a
# device (parallel/mesh.py), as the JAX package's tests run on virtual
# host devices.  With more than one card, part 2 also runs on all.

MESH_SHARDS = 4


def fasta_bytes(records):
    """The FASTA the CLI writes for (name, codes, solid) records."""
    from consent_tpu_torch.io import seqs

    return "".join(f">{n}\n{seqs.decode(c, s)}\n"
                   for n, c, s in records if len(c)).encode()


def mesh_run(tag, fn, need):
    """fn() with the launch counters set to 0 just before and read just
    after: (result, info) with the wall s, launches by lane count, graph
    replays by kind and by frag shard ("row,k"), and the banded kernel's
    eager launches (made outside any capture and not by a replay);
    every kernel in `need` must have launched."""
    import torch

    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.ops import graphs as graph_ops

    before = graph_ops.stats()
    cuda_align.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = cuda_align.lane_histogram()
    eager = cuda_align.eager_launch_counts()["banded_posterior"]
    replays = {k: v["replays"] for k, v in
               graph_delta(before["by_kind"]).items()}
    was = before["frag_shard_replays"]
    shard_replays = {k: n - was.get(k, 0) for k, n in
                     graph_ops.stats()["frag_shard_replays"].items()
                     if n - was.get(k, 0)}
    for name in need:
        if not hist[name]:
            raise AssertionError(f"[mesh] {tag}: kernel {name} never "
                                 f"launched")
    log(f"[mesh] {tag}: {wall:.3f} s, launches by lane count {hist}, "
        f"replays {replays}, frag graph replays by shard {shard_replays}, "
        f"eager banded launches {eager}")
    return out, dict(wall_s=wall, launches=hist, replays=replays,
                     shard_replays=shard_replays, eager_banded=eager)


def graph_run(tag, fn, need, shards):
    """mesh_run of a run on captured calls: no banded launch may be made
    eagerly, and with `shards` (frag shard labels "row,k") every shard
    must have replayed graphs."""
    out, info = mesh_run(tag, fn, need)
    if info["eager_banded"]:
        raise AssertionError(f"[mesh] {tag}: {info['eager_banded']} eager "
                             f"banded launches outside the graphs")
    missing = [k for k in shards if not info["shard_replays"].get(k)]
    if missing:
        raise AssertionError(f"[mesh] {tag}: no frag replays on shards "
                             f"{missing}")
    return out, info


def frag_labels(mesh):
    """Every frag shard of a mesh, as graphs.stats() labels them."""
    nd, nf = mesh.shape
    return [f"{d},{k}" for d in range(nd) for k in range(nf)]


def phase_mesh(rng, shards=None):
    """Mesh part 1: sharded_consensus_step at the correct shape (B =
    256 windows, S = 16 slots, 2 rounds, warm 0.25, banded aligner,
    packed fragments, assembled output) over `shards` (default [cuda:0]
    x 4) at frag 1, 2 and len(shards) op by op, each byte-equal to the
    one-device call on the first shard's card; at frag 2 and
    len(shards) the captured call too (each data row's frag chain),
    replayed from poisoned graph memory, byte-equal to the one-device
    and the op-by-op calls, with no eager banded launch and frag replays
    on every shard; then eager against graph in turns (eager, graph,
    graph, eager); then, at the widest frag axis, the split (put_batch)
    and the sum of the shards' partials timed."""
    import torch

    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.ops import consensus as cons_ops
    from consent_tpu_torch.ops import graphs as graph_ops
    from consent_tpu_torch.parallel import mesh as mesh_mod
    from consent_tpu_torch.pipeline.engine import ConsensusEngine

    shards = shards or [torch.device("cuda", 0)] * MESH_SHARDS
    dev, nf_max = shards[0], len(shards)
    cfg = correct_preset()
    eng = ConsensusEngine(cfg, device=dev, graphs=False)
    B, S = 256, 16
    arrays = consensus_arrays(rng, eng, B, S)
    want = graph_ops.run_eager(eng._wire_fn(S, eng.rounds),
                               cons_ops.wire_encode_inputs(*arrays),
                               dev).result()
    pk, frag_len, tpl, tpl_len, d0 = arrays
    out = dict(B=B, S=S, rounds=eng.rounds, by_frag={})
    eager_line = {}
    for nf in sorted({1, 2, nf_max}):
        mesh = mesh_mod.make_mesh(shards, frag_axis=nf)

        def step(graphs=False):
            res = mesh_mod.sharded_consensus_step(
                mesh, pk, frag_len, tpl, tpl_len, S=S,
                min_column_support=cfg.min_column_support,
                scoring=eng.scoring, frag_d0=d0, packed=True,
                frags_packed=True, rounds=eng.rounds, assemble_out=True,
                warm_frac=cfg.warm_frac, graphs=graphs)
            if graphs:
                return res.result()
            cons, lens = res
            return torch.cat([cons, cons_ops._bytes32(lens[:, None])],
                             1).numpy()

        step()                                            # warm-up
        got, info = mesh_run(
            f"part 1: sharded_consensus_step op by op, mesh {mesh.shape}",
            step, ["banded_posterior"])
        if not np.array_equal(got, want):
            raise AssertionError(f"[mesh] frag {nf}: sharded consensus "
                                 f"differs from the one-device call")
        res = dict(mesh=mesh.shape, wall_ms=info["wall_s"] * 1e3,
                   launches=info["launches"]["banded_posterior"])
        eager_line[f"frag {nf} op by op"] = info["eager_banded"]
        if nf > 1:
            g0 = graph_ops.stats()
            t0 = time.perf_counter()
            step(graphs=True)                             # captures
            capture_s = time.perf_counter() - t0
            g1 = graph_ops.stats()
            poisoned = sum(poison_graph_memory(d)
                           for d in dict.fromkeys(shards))
            got_g, ginfo = graph_run(
                f"part 1: captured frag call, mesh {mesh.shape}",
                lambda: step(graphs=True), ["banded_posterior"],
                frag_labels(mesh))
            if got_g.dtype != want.dtype or not np.array_equal(got_g, want) \
                    or not np.array_equal(got_g, got):
                raise AssertionError(f"[mesh] frag {nf}: captured call "
                                     f"differs from the one-device or the "
                                     f"op-by-op call")
            eager_line[f"frag {nf} graph"] = ginfo["eager_banded"]
            turns = []
            for mode in ("eager", "graph", "graph", "eager"):
                turns.append((mode, wall_ms(
                    lambda: step(graphs=mode == "graph"), 10)))
            log(f"[mesh] part 1: frag {nf} captured in {capture_s:.3f} s "
                f"({g1['graphs'] - g0['graphs']} graphs, static bytes "
                f"{g1['static_bytes']}, pool bytes {g1['pool_bytes']}); "
                f"byte-equal to the one-device and op-by-op calls from "
                f"{poisoned} poisoned bytes; in turns: "
                + ", ".join(f"{m} {ms:.3f} ms" for m, ms in turns))
            res.update(capture_s=capture_s,
                       graphs=g1["graphs"] - g0["graphs"],
                       static_bytes=g1["static_bytes"],
                       pool_bytes=g1["pool_bytes"], poisoned_bytes=poisoned,
                       graph_launches=ginfo["launches"]["banded_posterior"],
                       shard_replays=ginfo["shard_replays"], turns=turns,
                       eager_ms=[ms for m, ms in turns if m == "eager"],
                       graph_ms=[ms for m, ms in turns if m == "graph"])
        out["by_frag"][nf] = res
    log(f"[mesh] part 1: eager banded launches outside the graphs "
        f"{eager_line}")
    out["eager_banded"] = eager_line

    # the widest frag axis's split and all-reduce alone
    mesh = mesh_mod.make_mesh(shards, frag_axis=nf_max)
    specs = [("data", "frag", None), ("data", "frag"), ("data", None),
             ("data",), ("data", "frag")]
    with graph_ops.work_streams(shards):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = mesh_mod.put_batch(mesh, arrays, specs)[0]
        for d in mesh.distinct():
            torch.cuda.synchronize(d)
        split_ms = (time.perf_counter() - t0) * 1e3
        parts = [cons_ops.consensus_partials(
            cons_ops.unpack_bases(fr, fr.shape[-1] * 4), fl, tp, tl,
            S=S // nf_max, scoring=eng.scoring, frag_d0=d)
            for fr, fl, tp, tl, d in row]

        def allreduce():
            total = cons_ops.sum_partials(parts)
            return [[x.to(sh, non_blocking=True) for x in total]
                    for sh in shards]

        sum_ms = cuda_ms(allreduce, 20)
    part_bytes = sum(x.nbytes for x in parts[0])
    log(f"[mesh] part 1: frag {nf_max} split {split_ms:.3f} ms, "
        f"all-reduce of {nf_max} x {part_bytes} bytes of partials "
        f"{sum_ms:.3f} ms on {len(mesh.distinct())} card(s)")
    out.update(split_ms=split_ms, allreduce_ms=sum_ms,
               partial_bytes=part_bytes)
    return out


def mesh_chunk(piles, index, cfg, want_records):
    """Mesh part 2: the correct workload's profiled 1,024-read chunk
    through process_piles on [cuda:0] x 2 (data axis, captured calls,
    captured before the counters are reset), and on every card when
    there are more than one: the FASTA bytes equal the one-device
    run's, and no banded launch is eager."""
    import torch

    from consent_tpu_torch.pipeline import engine

    want = fasta_bytes(want_records)
    runs = [("[cuda:0] x 2", [torch.device("cuda", 0)] * 2)]
    n = torch.cuda.device_count()
    if n > 1:
        runs.append((f"cuda:0..{n - 1}",
                     [torch.device("cuda", i) for i in range(n)]))
    out = {}
    for tag, devs in runs:
        engine.ConsensusEngine(cfg, devices=devs)         # captures
        recs, info = graph_run(
            f"part 2: chunk of {len(piles)} piles on {tag}",
            lambda: list(engine.process_piles(iter(piles), index, cfg,
                                              devices=devs)),
            ["banded_posterior", "full_posterior"], [])
        if fasta_bytes(recs) != want:
            raise AssertionError(f"[mesh] chunk on {tag}: FASTA differs "
                                 f"from the one-device run")
        out[tag] = dict(info, bytes=len(want))
    log(f"[mesh] part 2: eager banded launches outside the graphs "
        f"{ {tag: r['eager_banded'] for tag, r in out.items()} }")
    return out


def mesh_deep(deep, shards=None):
    """Mesh part 3: the deep-pile cell through process_piles on
    `shards` (default [cuda:0] x 4) with every shard on the frag axis,
    set and chosen automatically (device_lanes 128 < s_cap 152), each
    with captured calls (the engine's default: every data row's frag
    chains, captured when the engine is built, before the counters are
    reset) and op by op (graphs=False): the FASTA bytes equal the
    one-device run's; the graph runs make no eager banded launch and
    replay graphs on every frag shard."""
    import dataclasses

    import torch

    from consent_tpu_torch.config import polish_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.ops import graphs as graph_ops
    from consent_tpu_torch.overlap import minimizer as mz
    from consent_tpu_torch.pipeline import engine

    _, draft, _, reads_fa = deep
    cfg = polish_preset(n_workers=os.cpu_count())
    index = ReadIndex()
    for name, codes in draft.items():
        index.add(name, codes)
    reads = ReadIndex.from_file(reads_fa)
    read_list = [(n, reads[n]) for n in reads.names()]
    for name, codes in read_list:
        index.add(name, codes)
    piles = list(mz.map_to_targets_piles(list(draft.items()), read_list,
                                         mz.OverlapParams(), cfg.max_support))
    shards = shards or [torch.device("cuda", 0)] * MESH_SHARDS
    card = shards[:1]
    engine.ConsensusEngine(cfg, devices=card)             # captures
    one, info1 = graph_run(
        "part 3: deep cell on one card",
        lambda: list(engine.process_piles(iter(piles), index, cfg,
                                          devices=card)),
        ["banded_posterior"], [])
    want = fasta_bytes(one)
    devs, nf = shards, len(shards)
    out = {"one card": info1, "bytes": len(want)}
    eager_line = {"one card": info1["eager_banded"]}
    for tag, c in ((f"frag {nf}", dataclasses.replace(cfg, frag_devices=nf)),
                   ("frag auto", dataclasses.replace(cfg, device_lanes=128))):
        g0 = graph_ops.stats()
        t0 = time.perf_counter()
        eng = engine.ConsensusEngine(c, devices=devs)     # captures
        capture_s = time.perf_counter() - t0
        g1 = graph_ops.stats()
        if eng.mesh.shape != (1, nf):
            raise AssertionError(f"[mesh] deep {tag}: mesh {eng.mesh.shape}")
        for graphs in (True, False):
            mode = "graph" if graphs else "op by op"
            run = mesh_run if not graphs else (
                lambda t, f, n: graph_run(t, f, n, frag_labels(eng.mesh)))
            recs, info = run(
                f"part 3: deep cell, {tag}, mesh {eng.mesh.shape}, {mode}",
                lambda: list(engine.process_piles(iter(piles), index, c,
                                                  devices=devs,
                                                  graphs=graphs)),
                ["banded_posterior"])
            if fasta_bytes(recs) != want:
                raise AssertionError(f"[mesh] deep {tag} {mode}: FASTA "
                                     f"differs from the one-device run")
            out[f"{tag} {mode}"] = info
            eager_line[f"{tag} {mode}"] = info["eager_banded"]
        out[f"{tag} capture"] = dict(
            capture_s=capture_s, graphs=g1["graphs"] - g0["graphs"],
            static_bytes=g1["static_bytes"], pool_bytes=g1["pool_bytes"])
        log(f"[mesh] part 3: {tag} captured {g1['graphs'] - g0['graphs']} "
            f"graphs in {capture_s:.3f} s; static bytes "
            f"{g1['static_bytes']}, pool bytes {g1['pool_bytes']}")
    log(f"[mesh] part 3: eager banded launches outside the graphs "
        f"{eager_line}")
    out["eager_banded"] = eager_line
    return out


def phase_profile(tag, piles, index, cfg):
    """The device's busy share over one chunk of piles: CUDA time
    recorded by torch.profiler over the wall time of process_piles under
    the profiler (which adds its own host overhead, so the share is a
    lower bound for an unprofiled run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from consent_tpu_torch.pipeline import engine

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in engine.process_piles(iter(piles), index, cfg,
                                      device="cuda"):
            pass
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of the kernels they launch, which would count twice
    by_op = sorted(
        ((e.key, e.self_device_time_total / 1e6)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        key=lambda kv: -kv[1],
    )
    device_s = sum(s for _, s in by_op)
    # each kernel's instantiations are named <name>[_warp|_block]_kernel<C>
    kernel_s = {name: sum(s for k, s in by_op
                          if re.search(rf"\b{name}(_\w+)?_kernel<", k))
                for name in REPLACES}
    log(f"[{tag}] profile of {len(piles)} piles: wall {wall_s:.3f} s, "
        f"device {device_s:.3f} s ({100 * device_s / wall_s:.1f}% busy), kernels "
        f"{kernel_s}; top: "
        + ", ".join(f"{k} {s:.3f} s" for k, s in by_op[:6]))
    return dict(n_piles=len(piles), wall_s=wall_s, device_s=device_s,
                busy_share=device_s / wall_s, kernel_device_s=kernel_s,
                top=by_op[:12])


PHASES = ("banded", "full", "repairs", "graphs", "consensus",
          "card_vs_cpu", "main", "polish", "mesh")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all; "
                         "anything less ends without the ok line)")
    only = set(ap.parse_args(argv).only.split(","))
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    card, build_s = phase_setup()
    rng = np.random.default_rng(0)
    res = {}
    if "banded" in only:
        res["banded"], res["banded_cases"] = phase_banded(rng)
    if "full" in only:
        res["full"] = phase_full(rng)
        res["full_widths"] = phase_full_widths(rng)
    if "repairs" in only:
        res["repairs"] = phase_repairs(rng)
    if "graphs" in only:
        res["graphs"] = phase_graphs(rng)
    if "consensus" in only:
        res["consensus_call"] = phase_consensus_call(rng)
    if "card_vs_cpu" in only:
        phase_card_vs_cpu()
    if only & {"main", "polish", "mesh"}:
        with tempfile.TemporaryDirectory() as workdir:
            if only & {"main", "polish"}:
                genome, reads, reads_fa = simulate_reads(
                    workdir, "main", genome_len=GENOME_LEN, **E2E)
                if "main" in only:
                    res["main"] = phase_main(genome, reads, reads_fa,
                                             workdir, mesh="mesh" in only)
                del reads
                if "polish" in only:
                    phase_polish_card_vs_cpu(workdir)
                    res["polish"] = phase_polish(genome, reads_fa, workdir)
            deep = (deep_inputs(workdir) if only & {"polish", "mesh"}
                    else None)
            if "polish" in only:
                res["polish_deep"] = phase_polish_deep(workdir, deep)
            if "mesh" in only:
                res["mesh"] = phase_mesh(rng)
                res["mesh"]["deep"] = mesh_deep(deep)
    if only != set(PHASES):
        print(json.dumps(dict(card=card, build_s=build_s, **res),
                         default=str))
        print(card)
        log(f"chip_smoke: ran only {sorted(only)}; no ok line")
        return 3

    banded, full = res["banded"], res["full"]
    main_res, polish_res = res["main"], res["polish"]
    deep_res = res["polish_deep"]
    kernels = []
    for r in (banded[0], full[256]):
        kernels.append(dict(
            name=r["name"], route="cuda",
            source=f"consent_tpu_torch/csrc/{r['name']}.cu",
            replaces=REPLACES[r["name"]], equal=r["equal"],
            launches=main_res["launches"][r["name"]],
            launches_polish=polish_res["launches"][r["name"]],
            launches_polish_deep=deep_res["launches"][r["name"]],
            launches_mesh_chunk=sum(main_res["mesh_chunk"]["[cuda:0] x 2"][
                "launches"][r["name"]].values()),
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None,
            shape=dict(N=r["N"], Lq=r["Lq"], W=r["W"], band=r["band"]),
        ))
    # other lane counts beside the timed ones: the banded kernel's deep
    # 152-slot bucket (polish), the full-width kernel's 1,024, 64 and 32
    banded_by_n = {r["N"]: r for r in banded}
    for k, by_n, ns in ((0, banded_by_n, (3952, 988)),
                        (1, full, (1024, 64, 32))):
        for n in ns:
            kernels[k][f"ms_n{n}"] = by_n[n]["kernel_ms"]
            kernels[k][f"plain_ms_n{n}"] = by_n[n]["plain_ms"]
            kernels[k][f"bound_ms_n{n}"] = by_n[n]["bound_ms"]
    detail = dict(card=card, build_s=build_s, banded_warm=banded[1],
                  banded_cases=res["banded_cases"],
                  full={n: {k: r[k] for k in ("kernel_ms", "plain_ms",
                                              "bound_ms", "cells",
                                              "matched_frac")}
                        for n, r in full.items()},
                  full_widths=res["full_widths"], repairs=res["repairs"],
                  graphs=res["graphs"],
                  consensus_call=res["consensus_call"],
                  main=main_res, polish=polish_res, polish_deep=deep_res,
                  mesh=res["mesh"])
    print(json.dumps(detail, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
