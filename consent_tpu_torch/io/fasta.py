"""FASTA/FASTQ reading/writing and the in-RAM read index.

Mirrors the reference's indexReads semantics (src/utils.cpp:166-205):
  * header key = text after '>'/'@' up to the first whitespace,
  * multi-line FASTA records are concatenated,
  * FASTQ quality lines are skipped,
  * sequences are uppercased (handled implicitly: our encoder is
    case-insensitive) and stored 2-bit-equivalent (uint8 codes).
"""

from __future__ import annotations

import io
from typing import Dict, Iterator, Tuple

import numpy as np

from consent_tpu_torch.io import seqs


def iter_fastx(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) from FASTA or FASTQ.

    Name is the first whitespace-delimited token of the header
    (reference: src/utils.cpp:174 splitString(header, " ")[0]).
    """
    with open(path, "rt") as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            yield from _iter_fasta(f)
        elif first == "@":
            yield from _iter_fastq(f)
        elif first == "":
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _iter_fasta(f: io.TextIOBase) -> Iterator[Tuple[str, str]]:
    name = None
    chunks: list[str] = []
    for line in f:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            name = line[1:].split()[0] if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def _iter_fastq(f: io.TextIOBase) -> Iterator[Tuple[str, str]]:
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip("\n")
        if not header:
            return
        # Multi-line FASTQ: sequence lines until '+' (reference handles
        # this, src/utils.cpp:181-186).
        chunks: list[str] = []
        line = f.readline().rstrip("\n")
        while line and line[0] != "+":
            chunks.append(line)
            line = f.readline().rstrip("\n")
        seq = "".join(chunks)
        # Skip as many quality lines as there were sequence lines.
        qlen = 0
        while qlen < len(seq):
            qline = f.readline().rstrip("\n")
            if not qline:
                break
            qlen += len(qline)
        name = header[1:].split()[0] if len(header) > 1 else ""
        yield name, seq


class ReadIndex:
    """name -> encoded sequence, the reference's readIndex equivalent
    (robin_hood::unordered_map<string, vector<bool>>,
    src/CONSENT-correction.cpp:16).  Stores uint8 code arrays."""

    def __init__(self) -> None:
        self._seqs: Dict[str, np.ndarray] = {}

    @classmethod
    def from_file(cls, path: str) -> "ReadIndex":
        idx = cls()
        idx.add_file(path)
        return idx

    def add_file(self, path: str) -> None:
        for name, seq in iter_fastx(path):
            self._seqs[name] = seqs.encode(seq)

    def add(self, name: str, sequence: str | np.ndarray) -> None:
        if isinstance(sequence, str):
            sequence = seqs.encode(sequence)
        self._seqs[name] = np.asarray(sequence, dtype=np.uint8)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._seqs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._seqs

    def __len__(self) -> int:
        return len(self._seqs)

    def length(self, name: str) -> int:
        return len(self._seqs[name])

    def names(self):
        return self._seqs.keys()


def write_fasta_record(f, name: str, sequence: str) -> None:
    """One `>name\\nseq` record — data on stdout/file exactly as the
    reference emits it (src/CONSENT-correction.cpp:102)."""
    f.write(f">{name}\n{sequence}\n")
