"""Seeded, vectorised simulation of a long-read data set.

The model is that of `consent_tpu_torch/testing/simulate.py` (and of the
JAX package's copy): a uniform random genome; reads of lengths
`read_len * [lo, hi]` placed uniformly on it; each base substituted,
followed by an inserted random base, or deleted, at `error_rate` split
by `frac_sub` / `frac_ins`; a share of the reads reverse-complemented.
That file draws its numbers base by base in a Python loop (74 s for
3.35 Mb at 10x); this one draws them in bulk, so the random stream
differs but the distribution is the same.

Every seed gets the same sizes: the read lengths are a fixed set of
evenly spaced quantiles of the length distribution, the reverse strand
takes exactly `reverse_frac` of them, and the contig lengths are fixed
quantiles of the spacings of uniform cuts.  The seed draws the genome,
the order of those sizes, the positions and the errors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[::-1]]


@dataclasses.dataclass
class Read:
    name: str
    codes: np.ndarray      # read bases, in the read's own orientation
    g_beg: int             # genome span [g_beg, g_end)
    g_end: int
    reverse: bool


def genome(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, n, dtype=np.uint8)


def mutate(rng: np.random.Generator, codes: np.ndarray, error_rate: float,
           frac_sub: float, frac_ins: float) -> np.ndarray:
    """codes with errors: per base, substitution with probability
    error_rate * frac_sub, the base then a random inserted base with
    error_rate * frac_ins, deletion with the rest of error_rate."""
    n = len(codes)
    p = rng.random(n, dtype=np.float32)
    e_sub = error_rate * frac_sub
    e_ins = error_rate * (frac_sub + frac_ins)
    sub = p < e_sub
    ins = (p >= e_sub) & (p < e_ins)
    dele = (p >= e_ins) & (p < error_rate)
    base = codes.copy()
    base[sub] = (codes[sub] + 1 + rng.integers(0, 3, int(sub.sum()),
                                               dtype=np.uint8)) % 4
    emit = (~dele).astype(np.int64) + ins
    ends = np.cumsum(emit)
    starts = ends - emit
    out = np.empty(int(ends[-1]) if n else 0, dtype=np.uint8)
    keep = ~dele
    out[starts[keep]] = base[keep]
    out[starts[ins] + 1] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    return out


def read_lengths(n: int, read_len: int, lo: float, hi: float) -> np.ndarray:
    """The fixed set of n read lengths: evenly spaced quantiles of
    read_len * U(lo, hi)."""
    q = (np.arange(n) + 0.5) / n
    return (read_len * (lo + (hi - lo) * q)).astype(np.int64)


def simulate_reads(rng: np.random.Generator, g: np.ndarray, coverage: float,
                   read_len: int, len_spread: Tuple[float, float],
                   error_rate: float, frac_sub: float, frac_ins: float,
                   reverse_frac: float) -> List[Read]:
    G = len(g)
    n = max(2, int(coverage * G / read_len))
    lens = np.minimum(rng.permutation(
        read_lengths(n, read_len, *len_spread)), G)
    begs = rng.integers(0, G - lens + 1)
    n_rev = int(round(reverse_frac * n))
    rev = rng.permutation(np.arange(n) < n_rev)
    reads = []
    for i in range(n):
        b, L = int(begs[i]), int(lens[i])
        noisy = mutate(rng, g[b: b + L], error_rate, frac_sub, frac_ins)
        reads.append(Read(f"read{i}", revcomp(noisy) if rev[i] else noisy,
                          b, b + L, bool(rev[i])))
    return reads


def contig_lengths(genome_len: int, n: int, min_len: int) -> np.ndarray:
    """The fixed set of n contig lengths summing to genome_len: min_len
    each plus the slack split by quantiles of the spacings of n - 1
    uniform cuts (exponential in the limit)."""
    q = (np.arange(n) + 0.5) / n
    w = -np.log1p(-q)
    extra = np.floor((genome_len - n * min_len) * w / w.sum()).astype(np.int64)
    lens = min_len + extra
    lens[-1] += genome_len - int(lens.sum())
    return lens


def cut_contigs(rng: np.random.Generator, g: np.ndarray, n: int,
                min_len: int, draft_error: float, frac_sub: float,
                frac_ins: float) -> Tuple[Dict[str, np.ndarray],
                                          Dict[str, np.ndarray]]:
    """The genome cut into contigs of the fixed lengths in an order drawn
    from rng, and a draft of each mutated at draft_error: (truth, draft)
    dicts by contig name, in genome order."""
    lens = rng.permutation(contig_lengths(len(g), n, min_len))
    cuts = np.concatenate([[0], np.cumsum(lens)])
    truth = {f"contig{i}": g[cuts[i]: cuts[i + 1]] for i in range(n)}
    draft = {name: mutate(rng, c, draft_error, frac_sub, frac_ins)
             for name, c in truth.items()}
    return truth, draft
