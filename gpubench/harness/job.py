"""The system under test: one cell's job, composed as the port's CLI
composes it.

`cli.main_correct` / `cli.main_polish` with the native overlapper and
no `--resume`: the flags of the cell's configuration become a config by
the CLI's own `_common_flags` and `_cfg_from_args`; the inputs go into
`ReadIndex`es as the CLI reads them (for polishing, the contigs' and
the reads' merged as `main_polish` merges them); the pile stream is the
CLI's own (`_correct_pile_stream` / `_polish_pile_stream`, the
minimizer overlapper); `engine.process_piles` runs it in chunks of
1,024 piles on the card's captured calls, and each output is written as
FASTA as `cli._drive` writes it.

The one piece the harness puts in: the stitch aligner handed to
`process_piles` is `CountingAligner`, which delegates every call to the
`FixedAligner` that `process_piles` would build and counts the lanes
that go to the card, for the full-width kernel's roofline.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from gpubench.harness import roofline

CHUNK_READS = 1024          # process_piles' default, the CLI's


class CountingAligner:
    """The port's FixedAligner with counts of the card's lanes: cells,
    ALU instructions and bytes of the full-width kernel, and a sample of
    (query, slab, span) for the check."""

    def __init__(self, inner, rng: np.random.Generator, keep: int = 64):
        self.inner = inner
        self.rng = rng
        self.keep = keep
        self.counting = False
        self.lanes = self.cells = self.ops = self.nbytes = 0
        self.seen = 0
        self.reserved = 0
        self._slots: List[Optional[tuple]] = [None] * keep

    def _card(self, handle) -> bool:
        return handle[0] != "done"

    def dispatch(self, qs, rs):
        handle = self.inner.dispatch(qs, rs)
        if not (self.counting and self._card(handle)):
            return handle, None
        width = max(-(-max(len(r) for r in rs) // 128) * 128,
                    self.inner.fixed_len)
        self.lanes += len(qs)
        picks = []
        for i, (q, r) in enumerate(zip(qs, rs)):
            ops, nbytes = roofline.full_width_work(len(q), len(r), width)
            self.cells += len(q) * len(r)
            self.ops += ops
            self.nbytes += nbytes
            # reservoir sample of the card's lanes
            self.seen += 1
            if self.reserved < self.keep:
                picks.append((i, self.reserved))
                self.reserved += 1
            else:
                j = int(self.rng.integers(0, self.seen))
                if j < self.keep:
                    picks.append((i, j))
        return handle, (qs, rs, picks)

    def collect(self, h):
        handle, picked = h
        spans = self.inner.collect(handle)
        if picked is not None:
            qs, rs, picks = picked
            for i, slot in picks:
                self._slots[slot] = (np.array(qs[i]), np.array(rs[i]),
                                     spans[i])
        return spans

    @property
    def samples(self) -> List[tuple]:
        return [s for s in self._slots if s is not None]

    def __call__(self, qs, rs):
        from consent_tpu_torch.pipeline.device_align import MAX_LANES_PER_CALL

        out = []
        for lo in range(0, len(qs), MAX_LANES_PER_CALL):
            out.extend(self.collect(self.dispatch(
                qs[lo: lo + MAX_LANES_PER_CALL],
                rs[lo: lo + MAX_LANES_PER_CALL])))
        return out


class PileTap:
    """The pile stream as the pipeline pulls it: the time it waits in
    each next() (overlap the pipeline waited for), the piles by name,
    and the order of their names."""

    def __init__(self, stream, clock: Callable[[], float], spans=None):
        self.it = iter(stream)
        self.clock = clock
        self.spans = spans
        self.wait_s = 0.0
        self.names: List[str] = []
        self.piles: Dict[str, object] = {}

    def __iter__(self):
        while True:
            t0 = self.clock()
            try:
                pile = next(self.it)
            except StopIteration:
                self._waited(t0)
                return
            self._waited(t0)
            self.names.append(pile.q_name)
            self.piles[pile.q_name] = pile
            yield pile

    def _waited(self, t0: float) -> None:
        t1 = self.clock()
        self.wait_s += t1 - t0
        if self.spans is not None:
            self.spans.add("overlap_wait", t0, t1)

    def close(self) -> None:
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


class Job:
    def __init__(self, config: dict, inputs, out_path: str,
                 device: str = "cuda"):
        from consent_tpu_torch import cli
        from consent_tpu_torch.io.fasta import ReadIndex

        self.kind = config["job"]
        self.correct = self.kind == "correct"
        p = argparse.ArgumentParser(prog=f"consent-{self.kind}")
        cli._common_flags(p, correct=self.correct)
        self.args = p.parse_args(list(config["flags"])
                                 + ["--out", out_path, "--device", device])
        if self.args.overlapper != "native" or self.args.paf:
            raise ValueError("the benchmark runs the native overlapper")
        self.cfg = cli._cfg_from_args(self.args, correct=self.correct)
        self.out_path = out_path
        queries = inputs.queries()
        if self.correct:
            self.index = ReadIndex()
            for name, codes in queries:
                self.index.add(name, codes)
            self.contig_index = self.read_index = None
        else:
            self.contig_index = ReadIndex()
            for name, codes in queries:
                self.contig_index.add(name, codes)
            self.read_index = ReadIndex()
            for r in inputs.reads:
                self.read_index.add(r.name, r.codes)
            # main_polish's merged map (CONSENT-polishing.cpp:114-117)
            self.index = ReadIndex()
            for n in self.contig_index.names():
                self.index.add(n, self.contig_index[n])
            for n in self.read_index.names():
                self.index.add(n, self.read_index[n])
        self.query_len = {name: len(codes) for name, codes in queries}
        self.engine = self.aligner = None

    def set_up(self, rng: np.random.Generator) -> None:
        """Build what the window needs before it starts: the native host
        library and both kernels (first run of a checkout only), the
        consensus calls captured for every shape (ConsensusEngine does
        that when built; process_piles' engine finds them), and the
        stitch's span calls captured for every lane count they take."""
        from consent_tpu_torch import native
        from consent_tpu_torch.pipeline import engine as eng
        from consent_tpu_torch.pipeline.device_align import FixedAligner

        native.get_lib()
        self.engine = eng.ConsensusEngine(self.cfg, device=self.args.device)
        inner = FixedAligner(self.cfg, device=self.engine.device,
                             mesh=self.engine.mesh)
        self.aligner = CountingAligner(inner, rng)
        if self.engine.graphs:
            self._warm_stitch(inner, rng)

    def _warm_stitch(self, inner, rng: np.random.Generator) -> None:
        """One span call at each lane count the stitch rounds make on
        the card (16 to 256 lanes: groups of at most a chunk's 1,024
        jobs over 4, above the host aligner's 8), at the pinned length."""
        from consent_tpu_torch.pipeline.device_align import NATIVE_MAX_LANES

        qlen = self.cfg.window_size
        rlen = self.cfg.window_size + 2 * self.cfg.window_overlap
        n = 2 * NATIVE_MAX_LANES
        while n <= CHUNK_READS // 4:
            qs = [rng.integers(0, 4, qlen, dtype=np.uint8) for _ in range(n)]
            rs = [rng.integers(0, 4, rlen, dtype=np.uint8) for _ in range(n)]
            inner.collect(inner.dispatch(qs, rs))
            n *= 2

    def pile_stream(self):
        from consent_tpu_torch import cli

        if self.correct:
            return cli._correct_pile_stream(self.args, self.index)
        return cli._polish_pile_stream(self.args, self.contig_index,
                                       self.read_index)

    def run_pass(self, tap_factory) -> Iterator[Tuple[str, np.ndarray,
                                                      np.ndarray]]:
        """One pass: the overlap stream through process_piles, every
        output written to the pass's FASTA (each pass overwrites the
        last)."""
        from consent_tpu_torch.io import seqs
        from consent_tpu_torch.io.fasta import write_fasta_record
        from consent_tpu_torch.pipeline import engine as eng

        tap = tap_factory(self.pile_stream())
        outputs = eng.process_piles(tap, self.index, self.cfg,
                                    batch_align=self.aligner,
                                    chunk_reads=CHUNK_READS,
                                    device=self.args.device)
        try:
            with open(self.out_path, "w") as out:
                for name, codes, solid in outputs:
                    if len(codes):
                        write_fasta_record(out, name,
                                           seqs.decode(codes, solid))
                    yield name, codes, solid
        finally:
            outputs.close()
            tap.close()
