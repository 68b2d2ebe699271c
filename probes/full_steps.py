#!/usr/bin/env python3
"""Where a step of the full-width kernel's wavefront goes, by variant.

Builds copies of consent_tpu_torch/csrc/full_posterior.cu into
build/full_steps/, each instrumented with clock64 and %globaltimer at the
passes' bounds (written over the outputs: the copies compute nothing
useful) and each with one piece removed:

  base         the kernel as shipped;
  no_store     the forward pass stages no hm;
  no_prefetch  neither pass loads the next rows' scores (the DP then
               runs on stale scores);
  no_hmload    the backward pass loads no staged hm (its on-path test
               then runs on stale hm).

Runs each on the main path's lanes (chip_smoke.full_lanes, 640 x 640,
stitch scoring) at N = 256 and 1,024 and prints, per variant, the time
of a launch and the mean cycles per forward and backward step of a lane
(one step is one row of each of the warp's 32 threads), with the SM
clock the two timers give.  Needs one CUDA card.

Usage: python3 probes/full_steps.py [--dry]   (--dry: write the copies
and stop, no card needed)
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "full_steps")

GLOBALTIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"'
# instrumentation: (anchor in the source, replacement)
PROBE = [
    ("    // ---------------- forward ----------------\n"
     "    // A thread's rows",
     "    const long long T0 = clock64(); unsigned long long G0; "
     + GLOBALTIMER + "(G0));\n"
     "    // ---------------- forward ----------------\n"
     "    // A thread's rows"),
    ("    if (lane == 0) a.opt[n] = opt;\n",
     "    const long long T1 = clock64();\n"),
    ("    // matched, the base and the packed insertion follow from the last"
     "\n    // matched row\n    __syncwarp();\n",
     "    const long long T2 = clock64(); unsigned long long G2; "
     + GLOBALTIMER + "(G2));\n    __syncwarp();\n"),
    ("        a.ins_pack[o] = la >= 0 ? pack_ins(qs, la, qlen, Lq) : 0;\n"
     "    }\n}\n",
     "        a.ins_pack[o] = la >= 0 ? pack_ins(qs, la, qlen, Lq) : 0;\n"
     "    }\n    __syncwarp();\n    if (lane == 0) {\n"
     "        a.opt[n] = static_cast<int>(T1 - T0);\n"
     "        a.base[static_cast<size_t>(n) * W] ="
     " static_cast<int>(T2 - T1);\n"
     "        a.ins_pack[static_cast<size_t>(n) * W] ="
     " static_cast<int>(G2 - G0);\n"
     "        a.ins_pack[static_cast<size_t>(n) * W + 1] ="
     " static_cast<int>(T2 - T0);\n    }\n}\n"),
]
VARIANTS = {
    "base": [],
    "no_store": [
        ("            store_hm<H>(hm_n + static_cast<size_t>(s) * (S / 2),"
         " lane, hm);\n", "")],
    "no_prefetch": [("            load_row(sub, r + 2);\n", ""),
                    ("            load_row(sub, r - 2);\n", "")],
    "no_hmload": [
        ("        if (s + 4 < steps) cur = load_hm<H>(slot(s + 4), lane);\n",
         "")],
}


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor not found once in the source: {old!r}")
    return src.replace(old, new)


def write_copies() -> dict:
    from consent_tpu_torch.ops import cuda_align

    with open(cuda_align.KERNELS["full_posterior"]) as f:
        src = f.read()
    for old, new in PROBE:
        src = replace_once(src, old, new)
    os.makedirs(OUT, exist_ok=True)
    paths = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            text = replace_once(text, old, new)
        paths[name] = os.path.join(OUT, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def main() -> int:
    paths = write_copies()
    if "--dry" in sys.argv:
        print(f"wrote {sorted(paths)} to {OUT}")
        return 0
    import torch

    import chip_smoke
    from consent_tpu_torch.ops import cuda_align
    from consent_tpu_torch.pipeline.device_align import _SCORING

    if not torch.cuda.is_available():
        print("full_steps: no CUDA device", file=sys.stderr)
        return 2
    builds = {name: subprocess.Popen(
        [cuda_align._nvcc(), *cuda_align.NVCC_FLAGS, p, "-o", p[:-3] + ".so"],
        stderr=subprocess.PIPE, text=True) for name, p in paths.items()}
    fns = {}
    for name, proc in builds.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{err}")
        fn = ctypes.CDLL(paths[name][:-3] + ".so").full_posterior_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 8)
        fns[name] = fn
    card = chip_smoke.card_line()
    rng = np.random.default_rng(0)
    sc = _SCORING
    W = Lq = 640
    for N in (256, 1024):
        q, ql, r, rl, _ = chip_smoke.full_lanes(rng, N, W)
        t = [torch.from_numpy(x).cuda() for x in (q, ql, r, rl)]
        qmax = np.minimum(ql, Lq).astype(np.int64)
        steps = np.where(qmax > 0, qmax + 31, 0)
        live = steps > 0
        for name, fn in fns.items():
            outs = cuda_align._outputs(N, W, t[0].device)
            hm = torch.empty((N, cuda_align.full_stage_slots(Lq),
                              cuda_align.full_stage_cols(W)),
                             dtype=torch.int16, device="cuda")

            def launch():
                rc = fn(*(x.data_ptr() for x in t), N, Lq, W, sc.match,
                        sc.mismatch, sc.gap_open, sc.gap_extend, W,
                        *(x.data_ptr() for x in outs), hm.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            ms = chip_smoke.cuda_ms(launch, 10)
            launch()
            torch.cuda.synchronize()
            fwd = outs[0].cpu().numpy().astype(np.int64)[live]
            bwd = outs[4][:, 0].cpu().numpy().astype(np.int64)[live]
            ns = outs[5][:, 0].cpu().numpy().astype(np.int64)[live]
            cyc = outs[5][:, 1].cpu().numpy().astype(np.int64)[live]
            print(json.dumps(dict(
                N=N, variant=name, ms=ms,
                fwd_cycles_per_step=float((fwd / steps[live]).mean()),
                bwd_cycles_per_step=float((bwd / steps[live]).mean()),
                sm_ghz=float((cyc / ns).mean()))), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
