"""The comparison that decides `correct`, and the error against the truth.

After the window has closed, a sample of its outputs drawn from the
seed is worked out again by the plain reference (reference/pipeline.py)
from the generated sequences alone, and compared with what the timed
path produced.  Each number counts disagreements and has the limit 0
(an exact comparison: the port is deterministic and its kernels are
integer code):

  config_diff  fields of the program's config that differ from the
               reference's, both made from the cell's flags;
  order_diff   outputs out of the piles' order, or missing: each pass
               yields one output per pile, in the order it took them;
  pile_diff    sampled outputs whose pile (targets, overlap rows) is not
               the reference overlapper's;
  span_diff    sampled full-width kernel lanes of the stitch whose span
               is not the plain aligner's;
  byte_diff    sampled outputs whose bases or case differ from the
               reference's (consensus, host post, stitch and trim
               together).

`control="int8"` puts the control in the program's place: the same
reference with every DP in int8, one type below the int16 the
configuration states.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gpubench.reference import pipeline as ref
from gpubench.reference.flags import config_from_flags
from gpubench.score.identity import identities

def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


LIMITS = {"config_diff": 0, "order_diff": 0, "pile_diff": 0,
          "span_diff": 0, "byte_diff": 0}


def order_diff(passes: Sequence[Tuple[List[str], List[str], bool]]) -> int:
    """Outputs that are not the piles taken, in order: per pass, the
    names yielded against the names the pipeline pulled from the pile
    stream.  It pulls ahead, so in the pass the window cut only their
    common prefix is due; a pass that ended owes every pile."""
    bad = 0
    for pulled, yielded, ended in passes:
        bad += sum(a != b for a, b in zip(yielded, pulled))
        bad += abs(len(yielded) - len(pulled)) if ended else max(
            0, len(yielded) - len(pulled))
    return bad


def _same_pile(a, b) -> bool:
    return (a is not None and b is not None and a.q_name == b.q_name
            and list(a.t_names) == list(b.t_names)
            and all(np.array_equal(a.ov[f], b.ov[f])
                    for f in a.ov.dtype.names))


def _same(a: Tuple[np.ndarray, np.ndarray],
          b: Tuple[np.ndarray, np.ndarray]) -> bool:
    return (np.array_equal(np.asarray(a[0], np.uint8),
                           np.asarray(b[0], np.uint8))
            and np.array_equal(np.asarray(a[1], bool),
                               np.asarray(b[1], bool)))


def sample_names(names: Sequence[str], k: int, seed: int,
                 stream: int) -> List[str]:
    rng = np.random.default_rng([seed, stream])
    names = list(names)
    if len(names) <= k:
        return names
    pick = rng.choice(len(names), k, replace=False)
    return [names[i] for i in sorted(pick)]


def error_pct(outputs: Dict[str, tuple], inputs, k: int, seed: int,
              device) -> Tuple[float, int]:
    """100 x (1 - mean identity against the truth) over k of the
    window's non-empty outputs drawn from the seed; and k."""
    names = sample_names([n for n, (c, _) in outputs.items() if len(c)],
                         k, seed, 1)
    if not names:
        raise RuntimeError("the window produced no output to score")
    ids = identities([(outputs[n][0], inputs.truth(n)) for n in names],
                     device=device)
    q = np.quantile(ids, [0.01, 0.05, 0.25, 0.5])
    log(f"identity over {len(ids)} outputs: mean {np.mean(ids):.6f}, "
        f"std {np.std(ids):.6f}, quantiles 1/5/25/50% "
        f"{', '.join(f'{x:.6f}' for x in q)}")
    return 100.0 * (1.0 - float(np.mean(ids))), len(names)


def compare(cell, inputs, port_cfg, outputs: Dict[str, tuple],
            piles: Dict[str, object], passes, span_samples: Sequence[tuple],
            seed: int, device, control: Optional[str] = None) -> dict:
    """The check's numbers, each {"value", "limit"}."""
    job = cell.config["job"]
    k = int(cell.traffic.get("check", {}).get("reference_sample", 16))
    rcfg = config_from_flags(job, cell.config["flags"])
    mine, theirs = dataclasses.asdict(rcfg), dataclasses.asdict(port_cfg)
    cfg_bad = sum(mine.get(f) != theirs.get(f)
                  for f in set(mine) | set(theirs))
    names = sample_names(list(outputs), k, seed, 2)
    seqs = inputs.sequences()
    t0 = time.perf_counter()
    if job == "correct":
        rpiles = ref.piles_correct(inputs.queries(), names, rcfg.max_support)
    else:
        rpiles = ref.piles_polish(inputs.queries(),
                                  [(r.name, r.codes) for r in inputs.reads],
                                  names, rcfg.max_support)
    times = {"overlap": time.perf_counter() - t0}
    pile_bad = sum(not _same_pile(rpiles[n], piles.get(n)) for n in names)
    want = ref.correct_piles(rpiles, seqs, rcfg, device, times=times)
    log(f"reference over {len(names)} outputs, seconds by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    got = outputs
    spans_got = [s for _, _, s in span_samples]
    if control is not None:
        if control != "int8":
            raise ValueError(f"unknown control {control!r}")
        got = ref.correct_piles(rpiles, seqs, rcfg, device, score_bits=8)
        spans_got = _spans(span_samples, rcfg, device, 8)
    byte_bad = sum(not _same(got[n], want[n]) for n in names)
    spans_want = _spans(span_samples, rcfg, device, 16)
    span_bad = sum(dataclasses.astuple(a) != dataclasses.astuple(b)
                   for a, b in zip(spans_got, spans_want))
    values = {"config_diff": cfg_bad, "order_diff": order_diff(passes),
              "pile_diff": pile_bad, "span_diff": span_bad,
              "byte_diff": byte_bad}
    return {n: {"value": v, "limit": LIMITS[n]} for n, v in values.items()}


def _spans(samples, rcfg, device, bits):
    if not samples:
        return []
    return ref.align_spans([q for q, _, _ in samples],
                           [r for _, r, _ in samples],
                           ref.stitch_fixed_len(rcfg), device, bits)


def passed(checks: dict) -> bool:
    """Every difference at or under its limit."""
    return all(checks[n]["value"] <= checks[n]["limit"] for n in LIMITS)
