"""Ground-truthed long-read simulation.

Generates a random genome, noisy reads (substitutions / insertions /
deletions at CLR-like rates, both strands), and *exact* all-vs-all
overlap records derived from the true genome coordinates — standing in
for minimap2 when testing the pipeline without an external overlapper.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from consent_tpu_torch.io import seqs
from consent_tpu_torch.io.paf import OVERLAP_DTYPE, Pile


@dataclasses.dataclass
class SimRead:
    name: str
    codes: np.ndarray        # read bases, read-forward orientation
    g_beg: int               # genome span [g_beg, g_end)
    g_end: int
    reverse: bool
    # genome offset -> read position (forward genome orientation):
    # g2r[i] = read position of genome base (g_beg + i) BEFORE strand
    # flip; for reverse reads, read_pos = len(read) - 1 - g2r[i].
    g2r: np.ndarray


def mutate(codes: np.ndarray, rng, error_rate: float,
           frac_sub=1 / 3, frac_ins=1 / 3) -> Tuple[np.ndarray, np.ndarray]:
    """Apply noise; returns (noisy codes, g2r position map)."""
    out: List[int] = []
    g2r = np.empty(len(codes), dtype=np.int64)
    for i, b in enumerate(codes):
        p = rng.random()
        g2r[i] = len(out)
        if p < error_rate * frac_sub:
            out.append((int(b) + 1 + int(rng.integers(0, 3))) % 4)
        elif p < error_rate * (frac_sub + frac_ins):
            out.append(int(b))
            out.append(int(rng.integers(0, 4)))
        elif p < error_rate:
            # deletion: map to the next emitted position
            g2r[i] = len(out)
        else:
            out.append(int(b))
    g2r = np.minimum(g2r, max(0, len(out) - 1))
    return np.array(out, dtype=np.uint8), g2r


def simulate(
    genome_len: int = 5000,
    coverage: float = 12.0,
    read_len: int = 1500,
    error_rate: float = 0.10,
    seed: int = 0,
    with_reverse: bool = True,
    frac_sub: float = 1 / 3,
    frac_ins: float = 1 / 3,
) -> Tuple[np.ndarray, List[SimRead]]:
    """Returns (genome codes, reads).  Reads tile the genome randomly at
    the requested coverage.  frac_sub/frac_ins shape the error profile
    (CLR default thirds; ONT-like: fewer subs, more indels)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    n_reads = max(2, int(coverage * genome_len / read_len))
    reads: List[SimRead] = []
    for idx in range(n_reads):
        L = int(read_len * (0.7 + 0.6 * rng.random()))
        L = min(L, genome_len)
        g0 = int(rng.integers(0, genome_len - L + 1))
        seg = genome[g0 : g0 + L]
        noisy, g2r = mutate(seg, rng, error_rate, frac_sub, frac_ins)
        rev = bool(with_reverse and rng.random() < 0.5)
        codes = seqs.revcomp(noisy) if rev else noisy
        reads.append(
            SimRead(
                name=f"read{idx}",
                codes=codes,
                g_beg=g0,
                g_end=g0 + L,
                reverse=rev,
                g2r=g2r,
            )
        )
    return genome, reads


def _project(read: SimRead, g_pos: int) -> int:
    """Genome position -> read-forward coordinate."""
    i = np.clip(g_pos - read.g_beg, 0, len(read.g2r) - 1)
    p = int(read.g2r[i])
    if read.reverse:
        p = len(read.codes) - 1 - p
    return int(np.clip(p, 0, len(read.codes) - 1))


def true_overlap(a: SimRead, b: SimRead) -> "tuple | None":
    """Exact overlap record (PAF-equivalent, inclusive ends) between two
    reads, or None if their genome spans don't overlap enough."""
    g0 = max(a.g_beg, b.g_beg)
    g1 = min(a.g_end, b.g_end)
    if g1 - g0 < 100:
        return None
    qa = sorted((_project(a, g0), _project(a, g1 - 1)))
    tb = sorted((_project(b, g0), _project(b, g1 - 1)))
    strand = a.reverse != b.reverse
    matches = int((g1 - g0) * 0.85)
    return (
        len(a.codes), qa[0], qa[1], strand,
        len(b.codes), tb[0], tb[1], matches, g1 - g0, 255,
    )


def piles_from_sim(reads: List[SimRead], max_support: int) -> List[Pile]:
    """All-vs-all exact-overlap piles, query order = read order, targets
    sorted by matches descending (as the reference's pile sort does)."""
    piles = []
    for a in reads:
        rows, names = [], []
        for b in reads:
            if b.name == a.name:
                continue
            ov = true_overlap(a, b)
            if ov is not None:
                rows.append(ov)
                names.append(b.name)
        if not rows:
            continue
        ov_arr = np.array(rows, dtype=OVERLAP_DTYPE)
        order = np.argsort(-ov_arr["matches"], kind="stable")[:max_support]
        piles.append(
            Pile(
                q_name=a.name,
                t_names=[names[i] for i in order],
                ov=ov_arr[order],
            )
        )
    return piles
