"""Share of the window that process_piles' main thread spent pulling
chunks of piles from the overlap stream (`pipeline.pull`, the program's
span around each next() on its chunk generator), in %."""


def read(m):
    if "pipeline.pull" not in m["stats_counts"] or m["window_s"] <= 0:
        return None
    return 100.0 * m["stats_seconds"]["pipeline.pull"] / m["window_s"]
