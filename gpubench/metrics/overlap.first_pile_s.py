"""Seconds to the first pile of a pass (`overlap.first_pile`: the
overlapper's index build and its first block of queries), the mean over
the passes of the window."""


def read(m):
    n = m["stats_counts"].get("overlap.first_pile", 0)
    if not n:
        return None
    return m["stats_seconds"]["overlap.first_pile"] / n
