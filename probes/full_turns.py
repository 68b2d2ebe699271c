#!/usr/bin/env python3
"""Parent against change: the full-width posterior kernel of two trees,
timed in turns on one card.

Makes the stitch's full-width lanes (chip_smoke.full_lanes: q and
template 640 wide, q_len uniform in [320, 640], lanes with q_len 0, 1
and 640 and an empty template, stitch scoring 2/-2/3/1, exact gaps) at
N = 256 (the main path's usual launch) and N = 1,024 from seed 0.  Then
it times each tree's own kernel on those inputs with CUDA events, in
turns parent, change, change, parent; every turn is a fresh process that
imports its tree's consent_tpu_torch and builds its own kernel there.
The change's six outputs must equal the parent's.  It also prints what
`nvcc -Xptxas -v` reports for this tree's kernel source (registers and
spills per instantiation).

Prints one JSON line per turn, a summary line, then the card's name and
power limit.  Needs one CUDA card.

Usage: python3 probes/full_turns.py PARENT_DIR
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = (256, 1024)
REPS = 20

# one turn: time a tree's kernel on the saved lanes, save its outputs
TURN = r"""
import json, sys
import numpy as np, torch
tree, lanes, out = sys.argv[1:4]
sys.path.insert(0, tree)
from consent_tpu_torch.ops import cuda_align
from consent_tpu_torch.pipeline.device_align import _SCORING
d = np.load(lanes)
res, keep = {}, {}
for N in map(int, sys.argv[4:]):
    t = [torch.from_numpy(d[f"{k}{N}"]).cuda() for k in ("q", "ql", "r", "rl")]
    def call():
        return cuda_align.full_posterior_summary(*t, _SCORING)
    got = call()
    torch.cuda.synchronize()
    for field in got._fields:
        keep[f"{field}{N}"] = getattr(got, field).cpu().numpy()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(%d):
        call()
    stop.record()
    torch.cuda.synchronize()
    res[N] = start.elapsed_time(stop) / %d
np.savez(out, **keep)
print(json.dumps(res))
""" % (REPS, REPS)


def ptxas_resources() -> list:
    """Registers and spills of each kernel in this tree's source."""
    from consent_tpu_torch.ops import cuda_align

    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [cuda_align._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-c",
             cuda_align.KERNELS["full_posterior"], "-o",
             os.path.join(tmp, "k.o")],
            capture_output=True, text=True, check=True)
    rows, name = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '.*?(full_posterior_\w+?)"
                      r"ILi(\d+)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            rows[name] = dict(kernel=name)
        elif name:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rows[name]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[name]["registers"] = int(m.group(1))
    return list(rows.values())


def main() -> int:
    import torch

    import chip_smoke

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("full_turns: no CUDA device", file=sys.stderr)
        return 2
    parent = os.path.abspath(sys.argv[1])
    card = chip_smoke.card_line()
    for row in ptxas_resources():
        print(json.dumps(row), flush=True)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        lanes = {}
        for N in SIZES:
            q, ql, r, rl, _ = chip_smoke.full_lanes(rng, N, 640)
            lanes.update({f"q{N}": q, f"ql{N}": ql, f"r{N}": r,
                          f"rl{N}": rl})
        lanes_path = os.path.join(tmp, "lanes.npz")
        np.savez(lanes_path, **lanes)
        times = {"parent": {N: [] for N in SIZES},
                 "change": {N: [] for N in SIZES}}
        outs = {}
        for k, who in enumerate(("parent", "change", "change", "parent")):
            tree = parent if who == "parent" else ROOT
            out = os.path.join(tmp, f"out{k}.npz")
            res = subprocess.run(
                [sys.executable, "-c", TURN, tree, lanes_path, out,
                 *map(str, SIZES)],
                cwd=tree, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{who} turn failed:\n{res.stderr}")
            ms = {int(n): v for n, v in json.loads(
                res.stdout.strip().splitlines()[-1]).items()}
            for N in SIZES:
                times[who][N].append(ms[N])
            outs.setdefault(who, out)
            print(json.dumps(dict(turn=k, tree=who, ms=ms)), flush=True)
        a, b = np.load(outs["parent"]), np.load(outs["change"])
        for key in a.files:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"change differs from parent in {key}")
    print(json.dumps(dict(card=card, equal=True, parent_ms=times["parent"],
                          change_ms=times["change"])))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
