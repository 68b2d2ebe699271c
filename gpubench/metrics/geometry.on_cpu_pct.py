"""Share of the geometry tasks' run time (one a pile) that their threads
spent on a CPU (`geometry.run.cpu` over `geometry.run`), in %: the rest
is waiting for the GIL, a lock or a core."""


def read(m):
    run = m["stats_seconds"].get("geometry.run", 0.0)
    if run <= 0 or "geometry.run.cpu" not in m["stats_counts"]:
        return None
    return 100.0 * m["stats_seconds"]["geometry.run.cpu"] / run
