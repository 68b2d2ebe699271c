"""`consensus.build_batch` + `dispatch` + `device_votes` thread-seconds
per 1,000 windows built into device batches, over the window."""


def read(m):
    n = m["stats_counts"].get("consensus.build_batch", 0)
    if not n:
        return None
    s = m["stats_seconds"]
    busy = sum(s.get(k, 0.0) for k in ("consensus.build_batch",
                                       "consensus.dispatch",
                                       "consensus.device_votes"))
    return busy / (n / 1000)
