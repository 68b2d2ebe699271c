"""Chunk-level checkpoint / resume.

The reference restarts from scratch on failure (its only intermediate
artifact is the temp PAF; SURVEY.md §5).  Here the pile stream is cut
into fixed-size chunks; each completed chunk's corrected records land
in `<out>.chunks/chunk_NNNNNN.fasta` with a manifest line, so a rerun
skips completed chunks and reprocesses only the tail.  Output assembly
concatenates chunks in order — byte-identical to an uninterrupted run.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Tuple

import numpy as np


class ResumeMismatch(ValueError):
    """The chunk store was produced under a different config/input."""


class ChunkStore:
    def __init__(self, out_path: str, run_key: dict | None = None):
        """run_key identifies the run (config + input); resuming a
        store written under a different key aborts loudly instead of
        silently mixing outputs from different flags/inputs."""
        self.dir = out_path + ".chunks"
        self.manifest = os.path.join(self.dir, "MANIFEST.jsonl")
        self.header_path = os.path.join(self.dir, "RUNKEY.json")
        os.makedirs(self.dir, exist_ok=True)
        if run_key is not None:
            key_str = json.dumps(run_key, sort_keys=True)
            if os.path.exists(self.header_path):
                old = open(self.header_path).read()
                if old != key_str:
                    raise ResumeMismatch(
                        f"refusing to resume {self.dir}: it was written "
                        f"under a different config/input.\n  stored: "
                        f"{old}\n  current: {key_str}\nDelete the "
                        f".chunks directory to start over."
                    )
            else:
                with open(self.header_path, "w") as f:
                    f.write(key_str)
        self._done = {}
        if os.path.exists(self.manifest):
            with open(self.manifest) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    self._done[rec["chunk"]] = rec

    def chunk_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"chunk_{idx:06d}.fasta")

    def is_done(self, idx: int) -> bool:
        rec = self._done.get(idx)
        return (
            bool(rec)
            and not rec.get("quarantined")
            and os.path.exists(self.chunk_path(idx))
        )

    def is_quarantined(self, idx: int) -> bool:
        rec = self._done.get(idx)
        return bool(rec) and bool(rec.get("quarantined"))

    def has_record(self, idx: int) -> bool:
        return idx in self._done

    def quarantine(self, idx: int, error: str) -> None:
        """Record a chunk that failed all retry attempts.  The run
        continues past it; a later rerun with --resume retries exactly
        the quarantined chunks (a fresh write_chunk record overrides
        this one — the manifest is append-only, last record wins)."""
        rec = {"chunk": idx, "quarantined": True, "error": error[:500]}
        with open(self.manifest, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._done[idx] = rec

    def quarantined_chunks(self) -> List[int]:
        return sorted(
            idx for idx, rec in self._done.items()
            if rec.get("quarantined")
        )

    def write_chunk(self, idx: int, records: List[Tuple[str, str]]) -> None:
        """records: (name, sequence-with-case) in pile order; atomic."""
        tmp = self.chunk_path(idx) + ".tmp"
        with open(tmp, "w") as f:
            for name, seq in records:
                f.write(f">{name}\n{seq}\n")
        os.replace(tmp, self.chunk_path(idx))
        with open(self.manifest, "a") as f:
            f.write(json.dumps({"chunk": idx, "n": len(records)}) + "\n")
        self._done[idx] = {"chunk": idx, "n": len(records)}

    def assemble(self, out_path: str) -> int:
        """Concatenate completed chunks in order into the final output;
        returns records written.  Quarantined chunks are skipped (their
        reads are absent until a --resume rerun repairs them); assembly
        stops at the first chunk with no manifest record at all."""
        n = 0
        with open(out_path, "w") as out:
            idx = 0
            while self.has_record(idx):
                if self.is_done(idx):
                    with open(self.chunk_path(idx)) as f:
                        for line in f:
                            out.write(line)
                            if line.startswith(">"):
                                n += 1
                idx += 1
        return n

    def n_complete_prefix(self) -> int:
        idx = 0
        while self.is_done(idx):
            idx += 1
        return idx
