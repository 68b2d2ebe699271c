#!/usr/bin/env python3
"""On-card smoke test of consent_tpu_torch, the PyTorch / CUDA port.

Needs one CUDA card and the repository checkout (it imports
consent_tpu_torch from beside this file; it imports neither jax nor
consent_tpu).  Phases, each failing the run by raising:

  1. setup: the card's name and power limit, torch / CUDA versions;
     builds both kernels (nvcc, in parallel) and the host library.
  2. the banded kernel against its plain PyTorch version at the main
     path's shapes: N = 4,096 (B = 256 windows x S = 16 slots) and the
     warm round's N = 1,280, q 512 x r 640, band 128.  Exact equality
     of all six outputs, then CUDA-event timings.
  3. the full-width kernel against its plain version: N = 1,024,
     640 x 640, stitch scoring, then 16 lanes at widths 1,000 to 4,096
     (several columns per thread; gap cap 16 too).  Same checks.  Then one whole consensus
     device call (B = 256, S = 16, 2 rounds) is timed.
  4. the main path: process_piles on the card against the CPU path on
     a small simulation (byte-identical), then `cli.main_correct` on
     the benchmarks/e2e_bench.py workload (3.35 Mb genome, 10x, 4 kb
     reads, 10% error, seed 7) with both kernels' launch counters reset
     just before and read just after; 600 reads scored against the
     truth as e2e_bench.py samples them, identity >= 0.98 required;
     then a torch.profiler trace of one 1,024-read chunk gives the
     device's busy share.
  5. a detail JSON line, one JSON line of per-kernel results, the card
     line, and the final {"ok": true, "device": ...} line.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
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


def kernel_vs_plain(name, q, q_len, r, r_len, d0, sc, reps):
    """Exact equality of the kernel and its plain version on the card,
    then both timed; returns a result dict."""
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
    want = plain()
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
    plain_ms = cuda_ms(plain, 1)

    N, Lq = q.shape
    W = r.shape[1]
    width = sc.band if sc.band else None
    rows = np.minimum(q_len, Lq).astype(np.int64)
    if width:
        cells = int(rows.sum()) * width
    else:
        cells = int((rows * np.minimum(r_len, W)).sum())
    ops = alu_per_cell(sc) * cells
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


def phase_banded(rng):
    from consent_tpu_torch.ops.align import Scoring
    from consent_tpu_torch.config import correct_preset

    cfg = correct_preset()
    sc = Scoring(cfg.match_score, cfg.mismatch_score, cfg.gap_open,
                 cfg.gap_extend, cfg.consensus_max_hgap, cfg.consensus_band)
    out = []
    for N in (4096, 1280):
        lanes = near_diagonal_lanes(rng, N, 512, 640)
        res = kernel_vs_plain("banded_posterior", *lanes, sc, reps=5)
        log(f"[banded] N={N}: equal; kernel {res['kernel_ms']:.3f} ms, "
            f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms"
            f" ({res['bound_by']}), matched {res['matched_frac']:.3f}")
        out.append(res)
    return out


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


def phase_full(rng):
    from consent_tpu_torch.pipeline.device_align import _SCORING

    q, q_len, r, r_len, d0 = near_diagonal_lanes(rng, 1024, 640, 640,
                                                 d0_lo=0, d0_hi=60)
    res = kernel_vs_plain("full_posterior", q, q_len, r, r_len, d0,
                          _SCORING, reps=5)
    log(f"[full] N=1024: equal; kernel {res['kernel_ms']:.3f} ms, "
        f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']}), matched {res['matched_frac']:.3f}")
    return res


def phase_full_widths(rng):
    """The full-width kernel against its plain version at template
    widths past one thread per column (2 and 4 columns per thread), at
    a width that leaves part of the last warp idle, and with the gap cap
    of the consensus aligner when its band is 0.  Exact equality; few
    lanes, so the plain version's row loop stays short."""
    from consent_tpu_torch.ops.align import Scoring
    from consent_tpu_torch.pipeline.device_align import _SCORING

    capped = Scoring(2, -4, 4, 2, max_hgap=16, band=0)
    out = []
    for W, sc in ((1000, _SCORING), (1152, _SCORING), (1152, capped),
                  (2500, _SCORING), (4096, capped)):
        lanes = near_diagonal_lanes(rng, 16, W, W, d0_lo=0, d0_hi=60)
        res = kernel_vs_plain("full_posterior", *lanes, sc, reps=2)
        log(f"[full] N=16, W={W}, max_hgap={sc.max_hgap}: equal; kernel "
            f"{res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"matched {res['matched_frac']:.3f}")
        out.append(dict(W=W, max_hgap=sc.max_hgap, kernel_ms=res["kernel_ms"],
                        plain_ms=res["plain_ms"],
                        matched_frac=res["matched_frac"]))
    return out


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


def phase_main(genome_len, workdir):
    from consent_tpu_torch import cli
    from consent_tpu_torch.io import seqs
    from consent_tpu_torch.io.fasta import iter_fastx
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.overlap import minimizer as mz
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.testing import metrics, simulate
    from consent_tpu_torch.utils.observe import GLOBAL_STATS

    t0 = time.perf_counter()
    genome, reads = simulate.simulate(genome_len=genome_len, **E2E)
    reads_fa = os.path.join(workdir, "reads.fasta")
    with open(reads_fa, "w") as f:
        for rd in reads:
            f.write(f">{rd.name}\n{seqs.decode(rd.codes)}\n")
    n_bases = int(sum(len(rd.codes) for rd in reads))
    log(f"[main] simulated {len(reads)} reads, {n_bases / 1e6:.3f} Mb "
        f"({time.perf_counter() - t0:.1f} s, excluded)")

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
    cuda_align.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main_correct(["--in", reads_fa, "--out", out_fa,
                           "--overlapper", "native", "--stats"])
    correct_s = time.perf_counter() - t0
    launches = cuda_align.launch_counts()
    if rc != 0:
        raise AssertionError(f"main_correct returned {rc}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    stats = GLOBAL_STATS.snapshot()
    n_windows = stats["counts"].get("windows.total", 0)
    pipe_s = stats["seconds"].get("consent-correct.pipeline", correct_s)
    log(f"[main] main_correct {correct_s:.3f} s (streamed overlap + "
        f"pipeline {pipe_s:.3f} s), {n_windows} windows, "
        f"{n_windows / pipe_s:.2f} windows/s, launches {launches}")

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
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=os.cpu_count() or 1,
                             mp_context=mp.get_context("spawn")) as pool:
        ids = list(pool.map(metrics.identity, *zip(*pairs), chunksize=8))
    cor_id = float(np.mean(ids[0::2]))
    raw_id = float(np.mean(ids[1::2]))
    log(f"[main] identity raw {raw_id:.4f} -> corrected {cor_id:.4f} on "
        f"{len(sample)} reads ({time.perf_counter() - t0:.1f} s scoring)")
    if not cor_id >= 0.98:
        raise AssertionError(f"corrected identity {cor_id:.4f} < 0.98")
    profile = phase_profile(piles[:1024], reads)
    return dict(
        profile=profile,
        genome_len=genome_len, n_reads=len(reads), n_out=len(results),
        n_windows=n_windows, overlap_wall_s=overlap_s,
        correct_wall_s=correct_s, pipeline_wall_s=pipe_s,
        windows_per_s=n_windows / pipe_s, raw_identity=raw_id,
        corrected_identity=cor_id, n_scored=len(sample),
        launches=launches,
    )


def phase_profile(piles, reads):
    """The device's busy share over one chunk of the main path (the
    first 1,024 piles): CUDA time recorded by torch.profiler over the
    wall time of process_piles under the profiler (which adds its own
    host overhead, so the share is a lower bound for an unprofiled run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.pipeline import engine

    index = ReadIndex()
    for rd in reads:
        index.add(rd.name, rd.codes)
    cfg = correct_preset(n_workers=os.cpu_count())
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
    log(f"[profile] {len(piles)} piles: wall {wall_s:.3f} s, device "
        f"{device_s:.3f} s ({100 * device_s / wall_s:.1f}% busy); top: "
        + ", ".join(f"{k} {s:.3f} s" for k, s in by_op[:6]))
    return dict(n_piles=len(piles), wall_s=wall_s, device_s=device_s,
                busy_share=device_s / wall_s, top=by_op[:12])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    card, build_s = phase_setup()
    rng = np.random.default_rng(0)
    banded = phase_banded(rng)
    full = phase_full(rng)
    full_widths = phase_full_widths(rng)
    consensus_call = phase_consensus_call(rng)
    phase_card_vs_cpu()
    with tempfile.TemporaryDirectory() as workdir:
        main_res = phase_main(GENOME_LEN, workdir)

    kernels = []
    for res in (banded[0], full):
        kernels.append(dict(
            name=res["name"], route="cuda",
            source=f"consent_tpu_torch/csrc/{res['name']}.cu",
            replaces=REPLACES[res["name"]], equal=res["equal"],
            launches=main_res["launches"][res["name"]],
            max_abs_err=res["max_abs_err"], ms=res["kernel_ms"],
            kernel_ms=res["kernel_ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
            library_ms=None,
            shape=dict(N=res["N"], Lq=res["Lq"], W=res["W"],
                       band=res["band"]),
        ))
    detail = dict(card=card, build_s=build_s, banded_warm=banded[1],
                  full_widths=full_widths,
                  consensus_call=consensus_call,
                  main=main_res)
    print(json.dumps(detail))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
