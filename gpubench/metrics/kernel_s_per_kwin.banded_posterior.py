"""Device seconds of the banded kernel (csrc/banded_posterior.cu, every
instantiation, by name from torch.profiler) per 1,000 windows whose
consensus calls were dispatched in the window.  It stands in for the
kernel's roofline share: the lanes' query lengths live inside the
captured consensus call, where the harness cannot count them."""


def read(m):
    tr = m["trace"]
    n = m["stats_counts"].get("consensus.dispatch", 0)
    if tr is None or not n or not tr["kernel_s"].get("banded_posterior"):
        return None
    return tr["kernel_s"]["banded_posterior"] / (n / 1000)
