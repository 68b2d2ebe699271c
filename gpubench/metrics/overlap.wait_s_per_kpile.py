"""Seconds the pipeline waited in next() on the pile stream (the
harness's span around each pull from the overlapper), per 1,000 piles
pulled in the window."""


def read(m):
    if not m["piles_pulled"]:
        return None
    return m["overlap_wait_s"] / (m["piles_pulled"] / 1000)
