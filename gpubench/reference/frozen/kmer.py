"""Dense k-mer count tables, on the host.

The reference threads robin_hood::unordered_map<kmer, unsigned> through
every stage (MSA weighting, DBG polish, stitch arbitration).  A dense
4^k table (4^9 = 262 144 slots) replaces the hash map outright:
counting is a bincount, probing is an array load.

These are the Python versions of the host post chain's k-mer steps,
which the engine reaches when the native library fails a capacity check
(pipeline/engine.py: _host_post_one).  The JAX package's device counter
(count_kmers_device) is dead there and is not ported.
"""

from __future__ import annotations

import numpy as np

from . import seqs


def count_kmers_host(frag_list, k: int) -> np.ndarray:
    """Host: dense counts [4^k] over a list of code arrays (one window's
    pile).  Equivalent to BMEAN's merCounts output consumed by
    weightConsensus / polishCorrection / alignConsensus."""
    n = 4 ** k
    total = np.zeros(n, dtype=np.int32)
    for codes in frag_list:
        ks = seqs.kmer_codes(codes, k)
        if len(ks):
            total += np.bincount(ks, minlength=n).astype(np.int32)
    return total


def count_anchors_host(frag_list, k: int, support: int) -> int:
    """Anchor count over one window's sequences (template first).

    The MSA give-up gate's statistic (reference: BMEAN's anchor scan
    feeding correctionMSA.cpp:31-36): an anchor is a k-mer occurring
    exactly once in the template and exactly once in each of >=
    `support` window sequences (template included).  Windows with fewer
    than minAnchors anchors fall back to the raw template."""
    if not frag_list or len(frag_list[0]) < k:
        return 0
    tpl_ks = seqs.kmer_codes(frag_list[0], k)
    uniq_t, cnt_t = np.unique(tpl_ks, return_counts=True)
    once_t = set(uniq_t[cnt_t == 1].tolist())
    if not once_t:
        return 0
    share: dict = {}
    for codes in frag_list:
        ks = seqs.kmer_codes(codes, k)
        if not len(ks):
            continue
        uniq, cnt = np.unique(ks, return_counts=True)
        for km in uniq[cnt == 1].tolist():
            if km in once_t:
                share[km] = share.get(km, 0) + 1
    return sum(1 for v in share.values() if v >= support)


def solidity_mask(consensus: np.ndarray, counts: np.ndarray, k: int,
                  solid_thresh: int) -> np.ndarray:
    """Case channel of the consensus (host).

    Mirrors weightConsensus (src/correctionMSA.cpp:6-27): the reference
    slides a k-window left to right, up/lower-casing [i, i+k-1] per
    k-mer solidity; since later windows overwrite earlier ones, the net
    effect is mask[p] = solid(kmer starting at min(p, L-k)).
    """
    L = len(consensus)
    if L < k:
        return np.zeros(L, dtype=bool)
    ks = seqs.kmer_codes(consensus, k)          # [L-k+1]
    solid = counts[ks] >= solid_thresh          # [L-k+1]
    idx = np.minimum(np.arange(L), L - k)
    return solid[idx]
