"""`stitch.align` + `stitch.apply` thread-seconds per 1,000 piles
stitched (`stitch.total`'s count), over the window."""


def read(m):
    n = m["stats_counts"].get("stitch.total", 0)
    if not n:
        return None
    s = m["stats_seconds"]
    return (s.get("stitch.align", 0.0) + s.get("stitch.apply", 0.0)) / (
        n / 1000)
