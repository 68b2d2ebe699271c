"""The full-width kernel's share of its roofline, in %: the least time
its work needs (the larger of its ALU instructions over 16.7 T/s and its
bytes over 3.35 TB/s, harness/roofline.py) over its device time by name
from torch.profiler.  The work is counted from the stitch lanes that
went to the card in the window (harness/job.py: CountingAligner): each
lane's query length x slab length cells, its inputs and outputs once."""

from gpubench.harness import roofline


def read(m):
    tr = m["trace"]
    card = m["stitch_card"]
    if tr is None or not card["lanes"] or not tr["kernel_s"].get(
            "full_posterior"):
        return None
    least = roofline.least_seconds(card["ops"], card["bytes"])
    return 100.0 * least / tr["kernel_s"]["full_posterior"]
