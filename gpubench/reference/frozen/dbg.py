"""Local de Bruijn graph polishing of window consensuses.

Faithful reimplementation of the reference's DBG repair pass
(src/correctionDBG.cpp:93-205 polishCorrection + src/DBG.cpp link /
extendLeft / extendRight), operating on:

  * codes: uint8 consensus bases,
  * solid: bool case-channel mask (uppercase == solid),
  * counts: dense 4^k k-mer table of the window's pile (replaces
    robin_hood::unordered_map<kmer, unsigned>).

The graph is implicit: successors of a k-mer are probed by 2-bit shifts
into the dense table (src/DBG.cpp:18-54).  Behavioral quirks preserved:

  * one `visited` set is shared across all anchor attempts and weak
    regions of a single polish call (declared function-scope in the
    reference, never cleared — correctionDBG.cpp:94),
  * `extendRight` follows the best neighbor even at branch points,
    while `extendLeft` stops on any branching (the reference's loop
    conditions differ — src/DBG.cpp:66 vs :87),
  * the repaired region is spliced at the *first* occurrence of the
    (case-sensitive) source..destination substring (string::find,
    correctionDBG.cpp:173),
  * path length budget maxSize = trunc(0.15*2*gap + gap + k)
    (correctionDBG.cpp:163), branch budget 50 (:100), zone = 3 (:102).

Host-side by design: the search touches few windows relative to the
batched consensus, and its pointer-chasing shape is a poor fit for the
VPU; the dense count table it probes is produced on device or via
bincount (ops/kmer.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MAX_BRANCHES = 50
ZONE = 3
ANCHORS_NB = 5


# ---------------------------------------------------------------------------
# implicit-graph neighbor probing


def neighbors_right(km: int, k: int, counts: np.ndarray, solid: int) -> List[int]:
    """Solid successors of k-mer `km`, best count first (src/DBG.cpp:18-54,
    left == 0 path).  Tie order follows generation order A,C,G,T (the
    reference's std::sort is unstable, so its tie order is unspecified)."""
    mask = (1 << (2 * k)) - 1
    base = (km << 2) & mask
    cand = [(int(counts[base | b]), base | b) for b in range(4)]
    cand = [(c, n) for c, n in cand if c >= solid]
    cand.sort(key=lambda x: -x[0])
    return [n for _, n in cand]


def neighbors_left(km: int, k: int, counts: np.ndarray, solid: int) -> List[int]:
    """Solid predecessors (left == 1 path).  The reference generates
    candidates via revcomp gymnastics yielding order T,G,C,A
    (src/DBG.cpp:24-44); mirrored here."""
    base = km >> 2
    shift = 2 * (k - 1)
    cand = [(int(counts[base | (b << shift)]), base | (b << shift))
            for b in (3, 2, 1, 0)]
    cand = [(c, n) for c, n in cand if c >= solid]
    cand.sort(key=lambda x: -x[0])
    return [n for _, n in cand]


def _codes_to_kmer(codes: np.ndarray) -> int:
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def _kmer_first_base(km: int, k: int) -> int:
    return (km >> (2 * (k - 1))) & 3


# ---------------------------------------------------------------------------
# extensions (src/DBG.cpp:56-96)


def extend_left(counts: np.ndarray, k: int, ext_len: int,
                codes: np.ndarray, solid: int) -> Tuple[np.ndarray, int]:
    """Extend leftward while the path is unique; returns (prepended
    extension codes, dist).  Stops on branching or dead end."""
    km = _codes_to_kmer(codes[:k])
    ext: List[int] = []
    dist = 0
    neigh = neighbors_left(km, k, counts, solid)
    while len(neigh) == 1 and dist < ext_len:
        km = neigh[0]
        ext.append(_kmer_first_base(km, k))
        dist += 1
        neigh = neighbors_left(km, k, counts, solid)
    ext.reverse()
    return np.array(ext, dtype=np.uint8), dist


def extend_right(counts: np.ndarray, k: int, ext_len: int,
                 codes: np.ndarray, solid: int) -> Tuple[np.ndarray, int]:
    """Extend rightward following the best neighbor, branching or not
    (the reference's loop doesn't require uniqueness here,
    src/DBG.cpp:87)."""
    km = _codes_to_kmer(codes[-k:])
    ext: List[int] = []
    dist = 0
    neigh = neighbors_right(km, k, counts, solid)
    while neigh and dist < ext_len:
        km = neigh[0]
        ext.append(km & 3)
        dist += 1
        neigh = neighbors_right(km, k, counts, solid)
    return np.array(ext, dtype=np.uint8), dist


# ---------------------------------------------------------------------------
# src -> dst path search (src/DBG.cpp:99-169)


class _Budget:
    __slots__ = ("branches", "max_branches")

    def __init__(self, max_branches: int = MAX_BRANCHES) -> None:
        self.branches = 0
        self.max_branches = max_branches


def link(
    counts: np.ndarray,
    src: int,
    dst: int,
    k: int,
    visited: set,
    budget: _Budget,
    dist: int,
    cur_ext: List[int],
    max_size: int,
    solid: int,
) -> Optional[List[int]]:
    """Bounded DFS from src k-mer to dst k-mer over solid k-mers.

    cur_ext is the path's base codes so far (starts as src's k codes);
    returns the full path codes (src..dst inclusive) or None.
    """
    if budget.branches > budget.max_branches or dist > max_size:
        return None

    anchor = _codes_to_kmer(np.array(cur_ext[-k:]))
    if anchor == dst:
        return cur_ext

    neigh = neighbors_right(anchor, k, counts, solid)
    it = 0
    # greedy while the path is unbranched
    while len(neigh) == 1 and it < len(neigh) and dist <= max_size:
        cur = neigh[it]
        if cur == dst:
            return cur_ext + [cur & 3]
        if cur not in visited:
            visited.add(cur)
            cur_ext = cur_ext + [cur & 3]
            dist += 1
            neigh = neighbors_right(cur, k, counts, solid)
            it = 0
        else:
            it += 1

    # branch exploration with backtracking
    while len(neigh) > 1 and it < len(neigh) and dist <= max_size:
        cur = neigh[it]
        if cur == dst:
            return cur_ext + [cur & 3]
        if cur not in visited:
            visited.add(cur)
            budget.branches += 1
            res = link(
                counts, src, dst, k, visited, budget,
                dist + 1, cur_ext + [cur & 3], max_size, solid,
            )
            if res is not None:
                return res
            it += 1
        else:
            it += 1

    return None


# ---------------------------------------------------------------------------
# weak-region scanning (correctionDBG.cpp:13-43)


def next_src(solid_mask: np.ndarray, beg: int, n: int) -> int:
    """End index of the solid run preceding the next weak region: scans
    while current is solid OR fewer than n solid seen; returns i-1 when
    a weak base follows >= n solid ones, else -1."""
    nb = 0
    i = beg
    L = len(solid_mask)
    while i < L and (solid_mask[i] or nb < n):
        nb = nb + 1 if solid_mask[i] else 0
        i += 1
    return i - 1 if nb >= n else -1


def next_dst(solid_mask: np.ndarray, beg: int, n: int) -> int:
    """End index of the first run of n solid bases at/after beg."""
    nb = 0
    i = beg
    L = len(solid_mask)
    while i < L and nb < n:
        nb = nb + 1 if solid_mask[i] else 0
        i += 1
    return i - 1 if nb >= n else -1


def get_anchors(
    counts: np.ndarray,
    src_zone: np.ndarray,
    dst_zone: np.ndarray,
    k: int,
    nb: int,
) -> List[Tuple[int, int, int, int]]:
    """Anchor k-mer pairs between the two zones, repeated k-mers
    excluded, ranked by summed counts, top `nb` kept
    (correctionDBG.cpp:47-91).  Returns (src_km, dst_km, src_pos,
    dst_pos) with positions of the (unique) occurrence in each zone."""
    def zone_kmers(zone: np.ndarray):
        n = len(zone) - k + 1
        kms = [ _codes_to_kmer(zone[i : i + k]) for i in range(n) ]
        first_pos = {}
        cnt = {}
        for i, km in enumerate(kms):
            cnt[km] = cnt.get(km, 0) + 1
            first_pos.setdefault(km, i)
        return kms, first_pos, cnt

    skms, spos, scnt = zone_kmers(src_zone)
    dkms, dpos, dcnt = zone_kmers(dst_zone)

    pairs = []
    for skm in skms:
        if scnt[skm] != 1:
            continue
        for dkm in dkms:
            if dcnt[dkm] != 1:
                continue
            pairs.append((skm, dkm))
    pairs.sort(key=lambda p: -(int(counts[p[0]]) + int(counts[p[1]])))
    return [
        (s, d, spos[s], dpos[d]) for s, d in pairs[:nb]
    ]


# ---------------------------------------------------------------------------
# the polish pass (correctionDBG.cpp:93-205)


def _find_subarray(codes: np.ndarray, solid: np.ndarray,
                   pat_codes: np.ndarray, pat_solid: np.ndarray) -> int:
    """First occurrence of (codes, solid) pattern — the reference's
    case-sensitive string::find (correctionDBG.cpp:173).  Combines both
    channels into one byte alphabet and uses bytes.find."""
    hay = (codes.astype(np.uint8) | (solid.astype(np.uint8) << 2)).tobytes()
    pat = (pat_codes.astype(np.uint8) | (pat_solid.astype(np.uint8) << 2)).tobytes()
    return hay.find(pat)


def polish_correction(
    codes: np.ndarray,
    solid_mask: np.ndarray,
    counts: np.ndarray,
    k: int,
    solid_thresh: int,
    max_branches: int = MAX_BRANCHES,
    zone: int = ZONE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Repair weak regions of a case-annotated consensus using solid
    k-mer paths; returns new (codes, solid_mask).

    max_branches / zone default to the reference's hardcoded budgets
    (correctionDBG.cpp:100,102) and are exposed as ConsentConfig
    max_branches / dbg_zone."""
    codes = np.asarray(codes, dtype=np.uint8).copy()
    solid = np.asarray(solid_mask, dtype=bool).copy()
    visited: set = set()
    tmp_src_beg = tmp_src_end = tmp_dst_beg = tmp_dst_end = 0

    # ---- weak head: try extending left from the first solid base ----
    L = len(codes)
    i = 0
    while i < L and not solid[i]:
        i += 1
    if 0 < i < L and L - i >= k:
        ext_len = i
        trimmed_c, trimmed_s = codes[i:], solid[i:]
        ext, ext_size = extend_left(counts, k, ext_len, trimmed_c, solid_thresh)
        new_c = [ext, trimmed_c]
        new_s = [np.ones(len(ext), dtype=bool), trimmed_s]
        if ext_size < ext_len:
            keep = ext_len - ext_size
            new_c.insert(0, codes[:keep])
            new_s.insert(0, solid[:keep])
            i = i - keep
        codes = np.concatenate(new_c)
        solid = np.concatenate(new_s)

    # ---- interior weak regions ----
    L = len(codes)
    while i < L:
        src_end = next_src(solid, i, k + zone)
        dst_end = next_dst(solid, src_end + 1, k + zone) if src_end != -1 else -1
        if src_end == -1 or dst_end == -1:
            break
        src_beg = src_end - (k + zone) + 1
        dst_beg = dst_end - (k + zone) + 1

        corrected: Optional[List[int]] = None
        anchors = get_anchors(
            counts, codes[src_beg : src_end + 1], codes[dst_beg : dst_end + 1],
            k, ANCHORS_NB,
        )
        for skm, dkm, sp, dp in anchors:
            if corrected is not None:
                break
            tmp_src_beg = src_beg + sp
            tmp_src_end = tmp_src_beg + k - 1
            tmp_dst_beg = dst_beg + dp
            tmp_dst_end = tmp_dst_beg + k - 1
            if skm != dkm:
                gap = tmp_dst_beg - tmp_src_end - 1
                max_size = int(15.0 / 100.0 * 2.0 * gap + gap + k)
                budget = _Budget(max_branches)
                src_codes = [int(c) for c in codes[tmp_src_beg : tmp_src_end + 1]]
                corrected = link(
                    counts, skm, dkm, k, visited, budget, 0,
                    src_codes, max_size, solid_thresh,
                )

        if corrected is not None:
            r_c = codes[tmp_src_beg : tmp_dst_end + 1]
            r_s = solid[tmp_src_beg : tmp_dst_end + 1]
            b = _find_subarray(codes, solid, r_c, r_s)
            if b != -1:
                reg = np.array(corrected, dtype=np.uint8)
                codes = np.concatenate([codes[:b], reg, codes[b + len(r_c):]])
                solid = np.concatenate(
                    [solid[:b], np.ones(len(reg), dtype=bool),
                     solid[b + len(r_c):]]
                )
                L = len(codes)
                i = b
            else:
                i = tmp_dst_beg if tmp_dst_beg > i else dst_beg
        else:
            i = tmp_dst_beg if tmp_dst_beg > i else dst_beg

    # ---- weak tail: try extending right from the last solid base ----
    L = len(codes)
    i = L - 1
    while i > 0 and not solid[i]:
        i -= 1
    if 0 < i < L - 1 and i + 1 >= k:
        ext_len = L - 1 - i
        old_c, old_s = codes, solid
        codes, solid = codes[: i + 1], solid[: i + 1]
        ext, ext_size = extend_right(counts, k, ext_len, codes, solid_thresh)
        parts_c = [codes, ext]
        parts_s = [solid, np.ones(len(ext), dtype=bool)]
        if ext_size < ext_len:
            keep = ext_len - ext_size
            parts_c.append(old_c[len(old_c) - keep :])
            parts_s.append(old_s[len(old_s) - keep :])
        codes = np.concatenate(parts_c)
        solid = np.concatenate(parts_s)

    return codes, solid
