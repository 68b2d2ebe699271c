"""Seconds the host post's window slices waited for a worker of the
shared pool (`host_post.queue`, from submit to start) per 1,000 windows
post-processed (`consensus.kmer_dbg`'s count)."""


def read(m):
    n = m["stats_counts"].get("consensus.kmer_dbg", 0)
    if not n or "host_post.queue" not in m["stats_counts"]:
        return None
    return m["stats_seconds"]["host_post.queue"] / (n / 1000)
