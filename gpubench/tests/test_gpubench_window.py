"""The window's closing rules and the rate arithmetic."""

import pytest

from gpubench.harness.window import Window, drive


def closes_at(events, seconds, chunk_reads, close):
    """The closing rule on (time, n_in_pass, pass_end) events: the time
    the window closes at, or None."""
    t = iter([0.0])
    w = Window(seconds, chunk_reads, close, clock=lambda: next(t))
    w.start()
    for when, n, end in events:
        t = iter([when])
        if w.pass_ended(n) if end else w.yielded(0, n):
            return w.t_close
    return None


def test_chunk_rule_closes_at_first_chunk_boundary_after_seconds():
    # chunks of 4 outputs; outputs at t = 1, 2, ...
    ev = [(float(i), i, False) for i in range(1, 13)]
    assert closes_at(ev, 5.0, 4, "chunk") == 8.0     # not at 5, 6 or 7
    assert closes_at(ev, 4.0, 4, "chunk") == 4.0     # a boundary at seconds
    assert closes_at(ev, 0.5, 4, "chunk") == 4.0     # never before one
    assert closes_at(ev, 13.0, 4, "chunk") is None


def test_pass_rule_closes_only_at_a_pass_end():
    ev = [(float(i), i, False) for i in range(1, 13)] + [(12.5, 12, True)]
    assert closes_at(ev, 5.0, 4, "pass") == 12.5     # no chunk closes it
    assert closes_at(ev, 0.5, 4, "pass") == 12.5
    assert closes_at(ev, 13.0, 4, "pass") is None


@pytest.mark.parametrize("close", ["pass", "chunk"])
def test_pass_end_is_a_boundary(close):
    ev = [(1.0, 1, False), (2.0, 2, False), (3.0, 3, False),
          (3.0, 3, True)]                        # a pass of 3 ends
    assert closes_at(ev, 2.5, 4, close) == 3.0
    # a pass ending on a full chunk
    ev = [(float(i), i, False) for i in range(1, 5)] + [(4.5, 4, True)]
    assert closes_at(ev, 3.5, 4, close) == (4.5 if close == "pass" else 4.0)


PASSES = [("a", 100), ("b", 300), ("c", 50), ("d", 50)]


def _drive(w):
    closed = []

    def run_pass():
        def gen(items):
            try:
                yield from items
            finally:
                closed.append(True)
        return gen(PASSES)

    drive(w, run_pass, lambda it: it[1])
    return closed


def test_rate_counts_every_output_to_the_close():
    # clock reads: start, chunk ends at 10, 20, pass end 20, chunk 30
    t = iter([0.0, 10.0, 20.0, 20.0, 30.0, 40.0])
    w = Window(25.0, 2, "chunk", clock=lambda: next(t))
    closed = _drive(w)
    assert w.t_close == 30.0 and w.outputs == 6
    assert w.bases == 2 * 500 - 100
    assert w.bases / w.seconds_measured == pytest.approx(900 / 30.0)
    assert w.passes == 1 and closed == [True, True]


def test_pass_rule_counts_whole_passes():
    # chunk ends at 10, 20, pass end 20, chunk ends 30, 40, pass end 41
    t = iter([0.0, 10.0, 20.0, 20.0, 30.0, 40.0, 41.0])
    w = Window(25.0, 2, "pass", clock=lambda: next(t))
    closed = _drive(w)
    assert w.t_close == 41.0 and w.outputs == 8 and w.passes == 2
    assert w.bases / w.seconds_measured == pytest.approx(1000 / 41.0)
    assert w.chunks == [10.0, 20.0, 30.0, 40.0]
    assert w.pass_ends == [20.0, 41.0] and closed == [True, True]


def test_window_rejects_nonsense():
    with pytest.raises(ValueError):
        Window(0, 1024)
    with pytest.raises(ValueError):
        Window(10, 1024, "second")
