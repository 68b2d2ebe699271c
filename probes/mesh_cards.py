#!/usr/bin/env python3
"""The device mesh over the host's real cards, against one card.

chip_smoke.py proves the mesh (consent_tpu_torch/parallel/mesh.py) on
shards of one card; this probe runs its three parts with one shard per
card, so the frag axis's partial sums and the copies back cross cards
and every card replays its own captured calls:

  1. sharded_consensus_step (B = 256, S = 16, 2 rounds, warm 0.25) over
     cuda:0..n-1 at frag 1, 2 and n op by op, and at frag 2 and n as
     captured frag chains (the partials copied between cards between
     replays) from poisoned graph memory, byte-equal to the one-card
     call, eager against graph in turns; the widest frag axis's split
     and all-reduce timed;
  2. a correct-shaped chunk (a 400 kb simulation, 10x, 4 kb reads,
     native overlaps, correct_preset) through process_piles on
     [cuda:0] x 2 and on cuda:0..n-1, FASTA bytes equal to one card's;
  3. the deep-pile cell on cuda:0..n-1 with every card on the frag axis,
     set and chosen automatically, with captured calls and op by op,
     bytes equal to one card's.

Needs two cards or more; prints the card line and one JSON line.

Usage: python3 probes/mesh_cards.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        cs.log(f"mesh_cards: needs two cards or more, found {n}")
        return 2
    card, _ = cs.phase_setup()
    cards = [torch.device("cuda", i) for i in range(n)]
    rng = np.random.default_rng(0)
    res = dict(card=card, cards=n, consensus=cs.phase_mesh(rng, cards))

    from consent_tpu_torch.config import correct_preset
    from consent_tpu_torch.io.fasta import ReadIndex
    from consent_tpu_torch.overlap import minimizer as mz
    from consent_tpu_torch.pipeline import engine

    with tempfile.TemporaryDirectory() as workdir:
        _, reads, _ = cs.simulate_reads(workdir, "cards", genome_len=400_000,
                                        **cs.E2E)
        piles = list(mz.all_vs_all_piles([(r.name, r.codes) for r in reads],
                                         mz.OverlapParams(),
                                         correct_preset().max_support))
        index = ReadIndex()
        for r in reads:
            index.add(r.name, r.codes)
        cfg = correct_preset(n_workers=os.cpu_count())
        one, info = cs.mesh_run(
            "part 2: chunk on one card",
            lambda: list(engine.process_piles(iter(piles), index, cfg,
                                              devices=cards[:1])),
            ["banded_posterior", "full_posterior"])
        res["chunk"] = dict(one_card_wall_s=info["wall_s"],
                            n_piles=len(piles),
                            **cs.mesh_chunk(piles, index, cfg, one))
        res["deep"] = cs.mesh_deep(cs.deep_inputs(workdir), cards)
    print(json.dumps(res, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
