"""The configuration from the cell's command-line flags, worked out by
the reference itself.

A frozen copy of the part of consent_tpu_torch/cli.py that turns flags
into a config (`_common_flags`'s flags and defaults that reach the
config, and `_cfg_from_args`), over the frozen presets of
frozen/config.py.  The harness holds the program's config equal to this
one, so a change of a default on either side shows."""

from __future__ import annotations

import argparse
import os
from typing import Sequence

from gpubench.reference.frozen.config import (ConsentConfig, correct_preset,
                                              polish_preset)


def config_from_flags(job: str, flags: Sequence[str]) -> ConsentConfig:
    correct = job == "correct"
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--type", choices=["PB", "ONT"], default="PB")
    p.add_argument("--windowSize", "-l", type=int, default=500)
    p.add_argument("--minSupport", "-s", type=int,
                   default=3 if correct else 1)
    p.add_argument("--maxSupport", "-S", type=int,
                   default=150 if correct else 20000)
    p.add_argument("--maxMSA", "-M", type=int, default=150)
    p.add_argument("--merSize", "-k", type=int, default=9)
    p.add_argument("--solid", "-f", type=int, default=4)
    p.add_argument("--anchorSupport", "-c", type=int, default=8)
    p.add_argument("--minAnchors", "-a", type=int, default=2)
    p.add_argument("--windowOverlap", "-o", type=int, default=50)
    p.add_argument("--nproc", "-j", type=int, default=os.cpu_count())
    p.add_argument("--consensus-rounds", type=int, default=2)
    args, _ = p.parse_known_args(list(flags))
    preset = correct_preset if correct else polish_preset
    return preset(
        window_size=args.windowSize,
        min_support=args.minSupport,
        max_support=args.maxSupport,
        max_msa=args.maxMSA,
        mer_size=args.merSize,
        solid_thresh=args.solid,
        common_kmers=args.anchorSupport,
        min_anchors=args.minAnchors,
        window_overlap=args.windowOverlap,
        consensus_rounds=args.consensus_rounds,
        n_workers=args.nproc,
        warm_frac=0.5 if args.type == "ONT" else 0.25,
    )
