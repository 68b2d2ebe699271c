#!/usr/bin/env python3
"""Staged hm against recomputed hm in the banded posterior kernel.

Builds the port's banded kernel (consent_tpu_torch/csrc/
banded_posterior.cu, hm staged in device memory) and the variant in
probes/banded_recompute.cu (hm recomputed in the backward pass from
(H, F) checkpoints every 32 rows, in shared memory), checks the variant
equal to the shipped kernel in all six outputs, and times both at the
main path's shapes (q 512 x template 640, band 128, gaps capped at 16;
N = 4,096 and the warm round's 1,280) with CUDA events, in turns:
staged, recompute, recompute, staged.

Prints one JSON line per shape, then the card's name and power limit.
Needs one CUDA card.

Usage: python3 probes/banded_hm.py
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "probes", "banded_recompute.cu")
REPS = 20


def main() -> int:
    import torch

    import chip_smoke
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.ops.align import Scoring
    from consent_tpu_torch.utils.build import build_shared

    if not torch.cuda.is_available():
        print("banded_hm: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    # the variant includes the shipped kernel's source: a change there
    # must rebuild it too
    with open(cuda_align.KERNELS["banded_posterior"], "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:8]
    lib = ctypes.CDLL(build_shared(
        f"banded_recompute-{tag}", [SRC],
        [[cuda_align._nvcc(), *cuda_align.NVCC_FLAGS]]))
    recompute_fn = lib.banded_recompute_launch
    recompute_fn.restype = ctypes.c_int
    recompute_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p] * 8

    cfg = correct_preset()
    sc = Scoring(cfg.match_score, cfg.mismatch_score, cfg.gap_open,
                 cfg.gap_extend, cfg.consensus_max_hgap, cfg.consensus_band)
    rng = np.random.default_rng(0)
    for N in (4096, 1280):
        t = [torch.from_numpy(x).cuda()
             for x in chip_smoke.banded_lanes(rng, N)]
        Lq, W = t[0].shape[1], t[2].shape[1]

        def staged():
            return cuda_align.banded_posterior_summary(*t, sc)

        def recompute():
            outs = cuda_align._outputs(N, W, t[0].device)
            rc = recompute_fn(
                *(x.data_ptr() for x in t), N, Lq, W, sc.band, sc.match,
                sc.mismatch, sc.gap_open, sc.gap_extend,
                cuda_align.scan_window(sc.max_hgap, sc.band),
                *(x.data_ptr() for x in outs), None,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"recompute launch failed: CUDA error {rc}")
            return outs

        want, got = staged(), recompute()
        torch.cuda.synchronize()
        for field, a, b in zip(want._fields, want, got):
            if not torch.equal(a, b):
                raise AssertionError(f"recompute differs from staged in "
                                     f"{field}")
        times = {"staged": [], "recompute": []}
        for name in ("staged", "recompute", "recompute", "staged"):
            fn = staged if name == "staged" else recompute
            times[name].append(chip_smoke.cuda_ms(fn, REPS))
        row = dict(N=N, Lq=Lq, W=W, band=sc.band, max_hgap=sc.max_hgap,
                   equal=True, staged_ms=times["staged"],
                   recompute_ms=times["recompute"], card=card)
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
