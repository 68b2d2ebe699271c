"""Seconds inside the native host post call (`host_post.native`:
host.cpp's host_post_batch, counts, anchors and DBG, the GIL released)
per 1,000 windows post-processed (`consensus.kmer_dbg`'s count)."""


def read(m):
    n = m["stats_counts"].get("consensus.kmer_dbg", 0)
    if not n or "host_post.native" not in m["stats_counts"]:
        return None
    return m["stats_seconds"]["host_post.native"] / (n / 1000)
