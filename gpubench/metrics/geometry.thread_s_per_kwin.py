"""`windows.geometry` thread-seconds per 1,000 windows it produced
(`windows.total`), over the window."""


def read(m):
    n = m["stats_counts"].get("windows.total", 0)
    if not n:
        return None
    return m["stats_seconds"].get("windows.geometry", 0.0) / (n / 1000)
