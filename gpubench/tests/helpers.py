"""Small cells for the CPU tests: the committed cells' files, scaled down
to a few dozen reads so that the port's plain kernels finish in seconds."""

from __future__ import annotations

import os
import time

from gpubench.harness import spec

# Cells whose files are kept for a later change to enter in
# BENCHMARK.json: polish-10x spread more than its bound allows on the
# hosts measured so far (PERF.md, Open questions).
LATER = {"configs": [{"name": "polish-pb",
                      "file": "gpubench/configs/polish-pb.json"}],
         "workloads": [{"name": "polish-10x", "config": "polish-pb",
                        "traffic": "sim-draft-10x", "chips": 1}]}


def load_cell(name: str):
    """A cell of BENCHMARK.json, or one of LATER."""
    b = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    for key, entries in LATER.items():
        have = {e["name"] for e in b[key]}
        b[key] += [e for e in entries if e["name"] not in have]
    return spec.load_cell(name, bench=b)


def tiny_cell(name: str = "correct-10x"):
    cell = load_cell(name)
    t = dict(cell.traffic, genome_len=4000,
             check={"error_sample": 64, "reference_sample": 4})
    t["reads"] = dict(t["reads"], read_len=1200, coverage=8)
    if "contigs" in t:
        t["contigs"] = {"n": 2, "min_len": 1500, "draft_error": 0.01}
    cell.traffic = t
    cell.config = dict(cell.config,
                       flags=list(cell.config["flags"]) + ["--nproc", "2"])
    return cell


def run_tiny(cell, seed: int = 7, **kw):
    from gpubench.harness.runner import run_cell

    t0 = time.perf_counter()
    return run_cell(cell, seed, 0.1, False, "cpu",
                    lambda: time.perf_counter() - t0, **kw)
