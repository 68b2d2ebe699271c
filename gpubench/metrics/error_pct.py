"""100 x (1 - mean identity against the simulated truth) over the sample
of the window's outputs that harness/check.py scores."""


def read(m):
    return m["error_pct"]
