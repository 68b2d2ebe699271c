"""Share of the window that process_piles' main thread spent in the
stitch slot's own work (`pipeline.stitch`: building the chunk's stitch
jobs, run_stitch and the trim, without the time it waits on the
consumer), in %."""


def read(m):
    if "pipeline.stitch" not in m["stats_counts"] or m["window_s"] <= 0:
        return None
    return 100.0 * m["stats_seconds"]["pipeline.stitch"] / m["window_s"]
