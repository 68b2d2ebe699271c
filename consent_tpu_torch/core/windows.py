"""Coverage, window positions, and fragment clipping.

Faithful reimplementation of the reference's window layer
(src/alignmentWindows.cpp) in vectorized NumPy.  The semantics here are
the bit-identity risk of the whole pipeline, so each function documents
the exact behavior it mirrors, including the quirks:

  * every emitted window is exactly `window_size` template bases long,
  * the forward scan never emits a window touching the final base
    (the push check happens with i < tplLen, :39-47); instead a single
    right-anchored window is appended by a right-to-left pass (:59-79) —
    appended *after* the others, possibly duplicating one of them,
  * fragments are clipped with three live cases (spanning /
    left-clipped / right-clipped); the contained-in branch of the
    reference (:119-123) is dead code because the admission condition
    (:117) excludes strictly-internal alignments — we keep only the live
    behavior,
  * '-'-strand fragments are reverse-complemented after slab extraction
    and before the shift/length cut (:133-138),
  * fragments shorter than mer_size are dropped (:141-143).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from consent_tpu_torch.io import seqs
from consent_tpu_torch.io.paf import Pile


def coverage(q_len: int, ov: np.ndarray) -> np.ndarray:
    """Per-base coverage from overlap extents, ends inclusive
    (reference: getCoverages, src/alignmentWindows.cpp:5-25)."""
    cov = np.zeros(q_len + 1, dtype=np.int64)
    np.add.at(cov, ov["q_start"], 1)
    np.add.at(cov, ov["q_end"] + 1, -1)
    return np.cumsum(cov[:-1])


def _runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal [start, end] (inclusive) runs of True."""
    if not mask.any():
        return []
    d = np.diff(mask.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1)
    if mask[0]:
        starts = np.concatenate([[0], starts])
    if mask[-1]:
        ends = np.concatenate([ends, [len(mask) - 1]])
    return list(zip(starts.tolist(), ends.tolist()))


def window_positions(
    q_len: int,
    cov: np.ndarray,
    min_support: int,
    window_size: int,
    window_overlap: int,
) -> List[Tuple[int, int]]:
    """Window [beg, end] (inclusive) list, reference order.

    Mirrors getAlignmentWindowsPositions (src/alignmentWindows.cpp:27-85):
    forward pass emits windows stepping window_size - window_overlap
    within coverage>=min_support runs, never touching the last base;
    then one right-anchored window from the rightmost long-enough run is
    appended (requiring its run end >= window_size + 1, an edge of the
    reference's `i > 0` loop guard, :64).
    """
    W, o = window_size, window_overlap
    ok = cov >= min_support
    runs = _runs(ok)
    out: List[Tuple[int, int]] = []

    # Forward pass: within each run, starts step by (W - o); a window is
    # only pushed if its end fits in the run and leaves at least one
    # base after it (end <= q_len - 2).
    step = W - o if o else W
    for rs, re in runs:
        limit = min(re, q_len - 2)
        s = rs
        while s + W - 1 <= limit:
            out.append((s, s + W - 1))
            s += step

    # Right-anchored last window: rightmost run of length >= W whose
    # right end re satisfies re >= W + 1 (loop-guard edge).
    for rs, re in reversed(runs):
        if re - rs + 1 >= W and re >= W + 1:
            out.append((re - W + 1, re))
            break

    return out


def clip_fragments(
    pile: Pile,
    sequences: dict,
    q_beg: int,
    q_end: int,
    mer_size: int,
    with_offsets: bool = False,
) -> List[np.ndarray]:
    """Extract this window's fragment of every admissible overlap.

    Mirrors getAlignmentWindowsSequences (src/alignmentWindows.cpp:87-149).
    `sequences` maps name -> uint8 code array (template + targets).
    Returns [template_fragment, frag1, ...]; empty list if the window
    falls off the template (reference guard :95-97).

    With `with_offsets=True`, returns (frags, d0s) where d0s[i] is the
    estimated window column where frags[i] base 0 aligns — the banded
    aligner's per-lane diagonal offset.  The estimate maps the slab
    start through the overlap's PAF span ratio (linear interpolation of
    indel drift), which the reference's unscaled clipping ignores; the
    residual random-walk drift stays well inside a 128-wide band.
    """
    W = q_end - q_beg + 1
    tpl = sequences[pile.q_name]
    if q_beg + W - 1 >= len(tpl):
        return ([], []) if with_offsets else []

    frags: List[np.ndarray] = [tpl[q_beg : q_beg + W]]
    d0s: List[int] = [0]

    ov = pile.ov
    for i in range(len(ov)):
        q_start = int(ov["q_start"][i])
        q_end_al = int(ov["q_end"][i])
        t_start = int(ov["t_start"][i])
        t_end_al = int(ov["t_end"][i])
        t_len = int(ov["t_len"][i])

        length = W
        shift = q_beg - q_start if q_beg > q_start else 0

        # Admission: alignment reaches into the window from the left, or
        # covers/extends past its right end (strictly-internal overlaps
        # are excluded — reference :117).
        admitted = (
            (q_start <= q_beg and q_end_al > q_beg)
            or (q_end <= q_end_al and q_start < q_end)
        ) and t_start + shift <= t_end_al
        if not admitted:
            continue

        t_beg, t_end = t_start, t_end_al
        if q_beg < q_start and q_end_al < q_end:
            # Reference branch :119-123 — unreachable given the
            # admission condition; kept for exact parity if it ever fires.
            shift = 0
            t_beg = max(0, t_start - (q_start - q_beg))
            t_end = min(t_len - 1, t_end_al + (q_end - q_end_al))
            length = t_end - t_beg + 1
        elif q_beg < q_start:
            shift = 0
            t_beg = max(0, t_start - (q_start - q_beg))
            length = min(length, min(t_len - 1, t_beg + length - 1) - t_beg + 1)
        elif q_end_al < q_end:
            t_end = min(t_len - 1, t_end_al + (q_end - q_end_al))
            length = min(length, t_end - max(0, t_end - length + 1) + 1)

        slab = sequences[pile.t_names[i]][t_beg : t_end + 1]
        if ov["strand"][i]:
            slab = seqs.revcomp(slab)
        frag = slab[shift : shift + length]

        if len(frag) >= mer_size:
            frags.append(frag)
            if with_offsets:
                # target coordinate of fragment base 0, mapped into
                # window columns through the overlap's span ratio
                if ov["strand"][i]:
                    tb0 = t_end - shift
                    t_rel = t_end_al - tb0
                else:
                    tb0 = t_beg + shift
                    t_rel = tb0 - t_start
                t_span = t_end_al - t_start
                q_span = q_end_al - q_start
                scale = q_span / t_span if t_span > 0 else 1.0
                qcol = q_start + t_rel * scale
                d0s.append(int(round(qcol)) - q_beg)

    return (frags, d0s) if with_offsets else frags


def sequences_map(pile: Pile, read_index) -> dict:
    """Decode template + all pile targets, the reference's
    getSequencesMap (src/alignmentPiles.cpp:5-20) — ours returns views
    into the uint8 index, no decode cost."""
    out = {pile.q_name: read_index[pile.q_name]}
    for name in pile.t_names:
        if name not in out:
            out[name] = read_index[name]
    return out
