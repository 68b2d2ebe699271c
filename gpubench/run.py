"""One run of one cell of consent_tpu_torch's benchmark, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration (the CLI flags of a correct or polish
job) and a traffic mix (the simulation's parameters).  The run makes the
inputs from the seed, sets the job up (kernels built on a checkout's
first run, every call shape captured), then runs whole passes of the job
(overlap, pipeline, FASTA) for `--seconds`, closing the window at the
next pass end (or chunk boundary, as the traffic mix says:
harness/window.py).  With --trace 0 it reports the end-to-end
metrics, with --trace 1 the per-layer metrics from torch.profiler and
the program's stage timers.  After the window it scores a sample of the
outputs against the simulated truth and checks another against the
plain reference (harness/check.py); the last line of standard output is
the result as JSON.

It fails, printing no result, without a card (or with fewer than the
cell asks for), and when JAX or the JAX package was loaded.
`--control int8` puts the reference computed one precision below the
stated one in the program's place, which has to come out not correct;
the benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _process_clock():
    """A function giving the seconds since this process started."""
    t_now = time.perf_counter()
    age = 0.0
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        pass
    return lambda: age + time.perf_counter() - t_now


def main(argv=None) -> int:
    clock = _process_clock()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8",), default=None)
    args = p.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    # (the port builds its libraries into build/ there itself)
    cache = os.path.join(ROOT, ".gpubench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)

    from gpubench.harness import imports, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("[gpubench] no CUDA card: the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"[gpubench] {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2

    from gpubench.harness.runner import run_cell

    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", clock,
                              control=args.control)
    bad = imports.forbidden_modules(sys.modules)
    if bad:
        print(f"[gpubench] the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
