"""`consensus.kmer_dbg` thread-seconds (the native counts, anchors and
DBG repair) per 1,000 windows post-processed, over the window."""


def read(m):
    n = m["stats_counts"].get("consensus.kmer_dbg", 0)
    if not n:
        return None
    return m["stats_seconds"].get("consensus.kmer_dbg", 0.0) / (n / 1000)
