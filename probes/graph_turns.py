#!/usr/bin/env python3
"""The whole correct pipeline, op by op against replayed graphs, in
turns on one card.

Simulates chip_smoke.py's correct workload (benchmarks/e2e_bench.py's:
3.35 Mb genome, 10x, 4 kb reads, 10% error, seed 7), materializes its
overlap piles with the native overlapper, then runs
`engine.process_piles` over every pile four times, in turns eager,
graph, graph, eager (chip_smoke.eager_vs_graph: the overlap is
excluded, the device calls and everything around them are not; all
four turns must write the same bytes).  Prints one JSON line with each
turn's wall seconds, windows/s and stage thread-seconds, then the
card's name and power limit.  Needs one CUDA card; ~6 minutes.

Usage: python3 probes/graph_turns.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_turns: no CUDA device", file=sys.stderr)
        return 2
    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.overlap import minimizer as mz
    from consent_tpu_torch.testing import simulate

    card = chip_smoke.card_line()
    _, reads = simulate.simulate(genome_len=chip_smoke.GENOME_LEN,
                                 **chip_smoke.E2E)
    index = ReadIndex()
    for rd in reads:
        index.add(rd.name, rd.codes)
    cfg = correct_preset(n_workers=os.cpu_count())
    piles = list(mz.all_vs_all_piles([(rd.name, rd.codes) for rd in reads],
                                     mz.OverlapParams(), cfg.max_support))
    turns = chip_smoke.eager_vs_graph(piles, index, cfg)
    print(json.dumps(dict(piles=len(piles), turns=turns)))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
