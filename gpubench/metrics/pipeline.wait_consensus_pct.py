"""Share of the window that process_piles' main thread waited on the
consensus slot (`pipeline.wait_consensus`: the device calls and the host
post of the next chunk not yet done), in %."""


def read(m):
    if "pipeline.wait_consensus" not in m["stats_counts"] or m[
            "window_s"] <= 0:
        return None
    return (100.0 * m["stats_seconds"]["pipeline.wait_consensus"]
            / m["window_s"])
