"""The timed window and its closing rule.

A pass is one whole job: the overlap index built over the inputs and
every pile streamed through to output.  The window starts a pass at
t = 0 and another over the same inputs whenever one ends.  It closes at
the first boundary at or after `seconds`.  What counts as a boundary is
the traffic mix's `close`:

  "pass"   (the default) the end of a pass: the window counts whole
           passes, each with its index build, its pipeline's fill and
           its drain, so it reads the wall a user pays per job whether
           a host fits one pass in it or several;
  "chunk"  the last output of every chunk of `chunk_reads` piles, and
           the end of a pass: for passes too long to run whole, the
           window lasts at most one chunk longer than `seconds`.

Either way it counts all the work and all the time up to the close,
with every stall inside.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

CLOSE_RULES = ("pass", "chunk")


class Window:
    def __init__(self, seconds: float, chunk_reads: int,
                 close: str = "pass",
                 clock: Callable[[], float] = time.perf_counter):
        if seconds <= 0 or chunk_reads <= 0:
            raise ValueError("seconds and chunk_reads must be positive")
        if close not in CLOSE_RULES:
            raise ValueError(f"close is one of {CLOSE_RULES}, not {close!r}")
        self.seconds = seconds
        self.chunk_reads = chunk_reads
        self.close = close
        self.clock = clock
        self.t0 = self.t_close = None
        self.bases = 0          # input bases of the piles yielded
        self.outputs = 0        # piles yielded
        self.passes = 0         # passes ended inside the window
        self.chunks = []        # seconds from the start of each chunk's end
        self.pass_ends = []     # seconds from the start of each pass's end

    def start(self) -> None:
        self.t0 = self.clock()

    def _closes(self, now: float) -> bool:
        if now - self.t0 >= self.seconds:
            self.t_close = now
            return True
        return False

    def yielded(self, bases: int, n_in_pass: int) -> bool:
        """One pile's output, the n-th of its pass: True when the window
        closes on it."""
        self.bases += bases
        self.outputs += 1
        if n_in_pass % self.chunk_reads:
            return False
        now = self.clock()
        self.chunks.append(now - self.t0)
        return self.close == "chunk" and self._closes(now)

    def pass_ended(self, n_in_pass: int) -> bool:
        """The pass ended after n outputs: True when the window closes."""
        self.passes += 1
        now = self.clock()
        self.pass_ends.append(now - self.t0)
        return self._closes(now)

    @property
    def seconds_measured(self) -> float:
        return self.t_close - self.t0


def drive(window: Window,
          run_pass: Callable[[], Iterator[tuple]],
          bases_of: Callable[[tuple], int],
          on_output: Callable[[tuple], None] = lambda item: None,
          on_close: Callable[[], None] = lambda: None) -> None:
    """Run passes until the window closes.  run_pass() starts one pass
    and yields its outputs.  on_close runs the moment the window closes;
    then the pass's generator is closed, so what its closing waits for
    (the stages already running) is not timed."""
    window.start()
    while True:
        it = run_pass()
        n = 0
        try:
            for item in it:
                n += 1
                on_output(item)
                if window.yielded(bases_of(item), n):
                    on_close()
                    return
            if n == 0:
                raise RuntimeError("a pass yielded no output")
            if window.pass_ended(n):
                on_close()
                return
        finally:
            it.close()
