#!/usr/bin/env python3
"""Measure the card's issue rate for int32 and DPX instructions.

Builds probes/int_rate.cu with nvcc for sm_90a, runs each variant over
every SM (16 blocks of 256 threads per SM), times it with CUDA events
and reads the SM clock inside the kernel (clock64 over %globaltimer).
Then it reads each variant's SASS with cuobjdump and counts the
instructions in its loop, so a rate is stated per instruction the card
issued, not per line of C.  Last, it counts the opcodes of the port's
two kernels (csrc/*.cu) as nvcc compiled them.

Prints one JSON object per variant and a summary line, and writes all
of it to chiprun_out/int_rate.json.  Needs one CUDA card.

Usage: python3 probes/int_rate.py
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "probes", "int_rate.cu")
VARIANTS = [
    "iadd", "imax", "add_then_max_in_c", "viaddmax_s32", "vimax3_s32",
    "vimax_s32_relu", "viaddmax_s32_relu", "viaddmax_s16x2",
]
UPDATES_PER_ITER = 32
THREADS = 256
BLOCKS_PER_SM = 16
ITERS = 4096
REPS = 5


def tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def loop_opcodes(sass: str) -> dict:
    """Opcodes of each rate_kernel<OP>'s innermost loop: the SASS
    between the loop's first instruction (the target of its backward
    branch) and that branch."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.search(r"rate_kernelILi(\d)E", name)
        if not m:
            continue
        insts = re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
            r"([^;]*);", block)
        addr = [int(a, 16) for a, _, _ in insts]
        loop = []
        for k, (a, op, args) in enumerate(insts):
            if op.startswith("BRA"):
                t = re.search(r"0x([0-9a-f]+)", args)
                if t and int(t.group(1), 16) < addr[k]:
                    lo = int(t.group(1), 16)
                    loop = [o.split(".")[0] for aa, o, _ in insts
                            if lo <= int(aa, 16) <= addr[k]]
                    break
        out[int(m.group(1))] = dict(Counter(loop))
    return out


def kernel_opcodes() -> dict:
    """Static opcode counts of each function in the port's two kernel
    libraries (the DPX ones among them show what nvcc fused)."""
    from consent_tpu_torch.ops import cuda_align

    out = {}
    for name in cuda_align.KERNELS:
        sass = subprocess.run(
            [tool("cuobjdump"), "-sass", cuda_align.build(name)],
            capture_output=True, text=True, check=True).stdout
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            fn = block.split("\n", 1)[0].strip()
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", block)
            out[fn] = dict(Counter(ops).most_common())
    return out


def main() -> int:
    import torch

    from consent_tpu_torch.ops.cuda_align import NVCC_FLAGS
    from consent_tpu_torch.utils.build import build_shared

    if not torch.cuda.is_available():
        print("int_rate: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib_path = build_shared("int_rate", [SRC], [[tool("nvcc"), *NVCC_FLAGS]])
    lib = ctypes.CDLL(lib_path)
    fn = lib.int_rate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    sass = subprocess.run([tool("cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "int_rate.sass"), "w") as f:
        f.write(sass)
    opcodes = loop_opcodes(sass)

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = n_sm * BLOCKS_PER_SM
    out = torch.zeros(blocks * THREADS, dtype=torch.int32, device="cuda")
    clocks = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(op):
        rc = fn(op, blocks, ITERS, 3, 12345, out.data_ptr(),
                clocks.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"int_rate launch failed: CUDA error {rc}")

    rows = []
    updates = blocks * THREADS * ITERS * UPDATES_PER_ITER
    for op, name in enumerate(VARIANTS):
        launch(op)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch(op)
        stop.record()
        torch.cuda.synchronize()
        s = start.elapsed_time(stop) / REPS / 1e3
        cyc, ns = clocks.tolist()
        clock_hz = cyc / ns * 1e9
        loop = opcodes.get(op, {})
        n_loop = sum(loop.values())
        # instructions issued per update, from the loop's SASS (the loop
        # runs UPDATES_PER_ITER updates per trip)
        per_update = n_loop / UPDATES_PER_ITER if n_loop else None
        row = dict(
            variant=name, seconds=s, updates_per_s=updates / s,
            sm_clock_mhz=clock_hz / 1e6,
            updates_per_clk_per_sm=updates / s / clock_hz / n_sm,
            loop_sass=loop, instructions_per_update=per_update,
            instructions_per_clk_per_sm=(
                updates * per_update / s / clock_hz / n_sm
                if per_update else None),
        )
        rows.append(row)
        print(json.dumps(row))
    kernels = kernel_opcodes()
    for name, ops in kernels.items():
        print(json.dumps(dict(kernel=name, sass=dict(
            list(ops.items())[:16]))))
    summary = dict(card=card, sms=n_sm, blocks=blocks, threads=THREADS,
                   iters=ITERS, torch=torch.__version__,
                   cuda=torch.version.cuda, variants=rows,
                   kernel_sass=kernels)
    with open(os.path.join(ROOT, "chiprun_out", "int_rate.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
