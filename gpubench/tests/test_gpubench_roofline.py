"""The full-width kernel's roofline on a toy call: the work counted from
the lanes that go to the card, as the reader reports it."""

import numpy as np
import pytest

from gpubench.harness import roofline, spec
from gpubench.harness.job import CountingAligner


class FakeAligner:
    fixed_len = 640

    def dispatch(self, qs, rs):
        kind = "done" if len(qs) <= 8 else "dev"
        return kind, [("span", len(q), len(r)) for q, r in zip(qs, rs)]

    def collect(self, handle):
        return handle[1]


def test_alu_per_cell():
    assert roofline.alu_per_cell(0) == 12            # exact gaps
    assert roofline.alu_per_cell(16) == 16           # capped at 16


def test_counts_only_card_lanes_and_reads_a_roofline():
    al = CountingAligner(FakeAligner(), np.random.default_rng(0), keep=4)
    al.counting = True
    rng = np.random.default_rng(1)
    qs = [np.zeros(int(rng.integers(300, 600)), np.uint8) for _ in range(16)]
    rs = [np.zeros(int(rng.integers(400, 600)), np.uint8) for _ in range(16)]
    al(qs[:5], rs[:5])                               # the host aligner's
    assert al.lanes == 0 and al.cells == 0
    spans = al(qs, rs)
    assert len(spans) == 16
    cells = sum(len(q) * len(r) for q, r in zip(qs, rs))
    assert al.lanes == 16 and al.cells == cells
    assert al.ops == sum(6 * len(q) * len(r) for q, r in zip(qs, rs))
    assert al.nbytes == sum(len(q) + 18 * len(r) + 12
                            for q, r in zip(qs, rs))
    assert len(al.samples) == 4
    al.counting = False
    al(qs, rs)
    assert al.lanes == 16

    read = spec.reader("full_posterior_roofline")
    least = max(al.ops / roofline.INT32_OPS_PER_S,
                al.nbytes / roofline.HBM_BYTES_PER_S)
    m = {"trace": {"kernel_s": {"full_posterior": 4 * least}},
         "stitch_card": {"lanes": al.lanes, "ops": al.ops,
                         "bytes": al.nbytes}}
    assert read(m) == pytest.approx(25.0)
    m["trace"]["kernel_s"]["full_posterior"] = 0
    assert read(m) is None                           # nothing to read
    assert read({"trace": None, "stitch_card": m["stitch_card"]}) is None
