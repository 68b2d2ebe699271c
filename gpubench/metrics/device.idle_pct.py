"""Share of the traced window in which the card ran no kernel, copy or
set (torch.profiler's CUDA activity), in %."""


def read(m):
    tr = m["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
