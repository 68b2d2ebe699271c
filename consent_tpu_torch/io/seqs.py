"""Sequence encoding and reverse complement.

Sequences live as numpy uint8 code arrays: A=0, C=1, G=2, T/other=3 —
the same 2-bit alphabet the reference packs into vector<bool>
(reference: src/utils.cpp:21-54 fullstr2num/fullnum2str, where any
non-ACGT byte encodes as T).  The "case channel" the reference threads
through ASCII case (solid vs weak bases, reference:
src/correctionMSA.cpp:6-27) is carried here as a separate uint8 mask —
case is only materialized when writing FASTA.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3

# ASCII byte -> 2-bit code; everything not in ACGTacgt maps to T (code 3),
# matching the reference encoder's `default:` branch (src/utils.cpp:28).
_ENCODE = np.full(256, T, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T)):
    _ENCODE[ord(_ch)] = _code
    _ENCODE[ord(_ch.lower())] = _code

_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)
_DECODE_LOWER = np.frombuffer(b"acgt", dtype=np.uint8)

# code -> complement code (A<->T, C<->G).
_COMP = np.array([T, G, C, A], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (case-insensitive, non-ACGT -> T)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray, solid: np.ndarray | None = None) -> str:
    """uint8 codes -> ASCII string.

    If `solid` is given (uint8/bool mask of the same length), solid
    positions are uppercase and weak ones lowercase — the reference's
    case channel (src/correctionMSA.cpp:15-24).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if solid is None:
        out = _DECODE[codes]
    else:
        solid = np.asarray(solid).astype(bool)
        out = np.where(solid, _DECODE[codes], _DECODE_LOWER[codes])
    return out.tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement on code arrays (reference:
    src/reverseComplement.cpp:6-23, minus the ASCII-case bookkeeping —
    case travels separately here)."""
    return _COMP[codes[::-1]]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 4 codes per byte (storage parity with the reference's 2-bit
    read index, src/utils.cpp:166-205). Length must be padded by caller
    or retrieved via the stored original length."""
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    padded = padded.reshape(-1, 4)
    return (
        (padded[:, 0] << 6) | (padded[:, 1] << 4)
        | (padded[:, 2] << 2) | padded[:, 3]
    ).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_2bit."""
    out = np.empty(len(packed) * 4, dtype=np.uint8)
    out[0::4] = (packed >> 6) & 3
    out[1::4] = (packed >> 4) & 3
    out[2::4] = (packed >> 2) & 3
    out[3::4] = packed & 3
    return out[:length]


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling 2-bit k-mer integers of a code array: length n-k+1.

    kmer[i] = sum_j codes[i+j] * 4^(k-1-j), identical numbering to the
    reference's str2num (BMEAN/utils.h, consumed by src/DBG.cpp:30).
    """
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.int64)
    weights = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(
        codes.astype(np.int64), k
    )
    return windows @ weights


def kmer_to_codes(kmer: int, k: int) -> np.ndarray:
    """Integer k-mer -> code array (reference kmer2str equivalent)."""
    out = np.empty(k, dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[i] = kmer & 3
        kmer >>= 2
    return out
