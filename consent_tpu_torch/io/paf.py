"""PAF parsing, reformatting, and pile streaming.

Semantics mirrored from the reference:
  * 12-column PAF; qEnd/tEnd are stored INCLUSIVE (minimap2 reports the
    position one past the last match, so both get -1; reference:
    src/Overlap.h:39,49),
  * strand True means '-' (src/Overlap.h:41),
  * a pile = consecutive PAF lines sharing qName (the PAF must be
    query-grouped; src/alignmentPiles.cpp:22-58), sorted descending by
    residue matches and truncated to maxSupport (:41-44),
  * reformat swaps query and target column groups, keeping the strand
    column — used by polishing so the contig becomes the query
    (src/reformatPAF.cpp:22-33).

Overlaps are held in a numpy structured array; names are kept in
side lists (object arrays) since they're only used for index lookups.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, TextIO

import numpy as np

# Numeric columns of an overlap record.  Names follow the reference's
# struct Overlap (src/Overlap.h:8-20).
OVERLAP_DTYPE = np.dtype(
    [
        ("q_len", np.int64),
        ("q_start", np.int64),
        ("q_end", np.int64),        # inclusive
        ("strand", np.bool_),       # True == '-'
        ("t_len", np.int64),
        ("t_start", np.int64),
        ("t_end", np.int64),        # inclusive
        ("matches", np.int64),
        ("block_len", np.int64),
        ("mapq", np.int64),
    ]
)


@dataclasses.dataclass
class Pile:
    """All overlaps of one query (read or contig)."""

    q_name: str
    t_names: List[str]              # parallel to rows of `ov`
    ov: np.ndarray                  # structured array, OVERLAP_DTYPE

    def __len__(self) -> int:
        return len(self.ov)

    @property
    def q_len(self) -> int:
        return int(self.ov["q_len"][0])


def parse_line(line: str) -> tuple[str, str, tuple]:
    """One PAF line -> (q_name, t_name, numeric tuple)."""
    c = line.rstrip("\n").split("\t")
    return (
        c[0],
        c[5],
        (
            int(c[1]),
            int(c[2]),
            int(c[3]) - 1,          # inclusive end
            c[4] == "-",
            int(c[6]),
            int(c[7]),
            int(c[8]) - 1,          # inclusive end
            int(c[9]),
            int(c[10]),
            int(c[11]),
        ),
    )


def iter_piles(f: TextIO, max_support: int) -> Iterator[Pile]:
    """Stream query-grouped piles from a PAF file object.

    Equivalent of repeatedly calling the reference's getNextReadPile
    (src/alignmentPiles.cpp:22-58): groups consecutive lines by qName,
    sorts each group by matches descending (stable, so PAF order breaks
    ties deterministically — the reference uses an unstable sort whose
    tie order is unspecified), and keeps the best max_support rows.
    """
    cur_name: str | None = None
    t_names: List[str] = []
    rows: List[tuple] = []

    def finish() -> Pile:
        ov = np.array(rows, dtype=OVERLAP_DTYPE)
        order = np.argsort(-ov["matches"], kind="stable")
        if len(order) > max_support:
            order = order[:max_support]
        return Pile(
            q_name=cur_name,
            t_names=[t_names[i] for i in order],
            ov=ov[order],
        )

    for line in f:
        if not line.strip():
            continue
        q_name, t_name, row = parse_line(line)
        if cur_name is not None and q_name != cur_name:
            yield finish()
            t_names, rows = [], []
        cur_name = q_name
        t_names.append(t_name)
        rows.append(row)

    if rows:
        yield finish()


def format_paf_line(q_name: str, t_name: str, row) -> str:
    """Inverse of parse_line: one OVERLAP_DTYPE row back to a
    12-column PAF line (inclusive ends re-widened to minimap2's
    one-past-the-end convention)."""
    return "\t".join(
        str(x)
        for x in (
            q_name,
            int(row["q_len"]),
            int(row["q_start"]),
            int(row["q_end"]) + 1,
            "-" if row["strand"] else "+",
            t_name,
            int(row["t_len"]),
            int(row["t_start"]),
            int(row["t_end"]) + 1,
            int(row["matches"]),
            int(row["block_len"]),
            int(row["mapq"]),
        )
    )


def write_piles_paf(piles, path: str, swap: bool = False) -> None:
    """Serialize piles to a PAF file (testing / interop helper).
    swap=True writes each overlap with query and target exchanged
    (undoing reformat_line — e.g. to fabricate the raw read-vs-contig
    PAF that minimap2 would emit before the polish sort+reformat
    chain)."""
    with open(path, "w") as f:
        for pile in piles:
            for t_name, row in zip(pile.t_names, pile.ov):
                line = format_paf_line(pile.q_name, t_name, row)
                f.write((reformat_line(line) if swap else line) + "\n")


def reformat_line(line: str) -> str:
    """Swap query<->target column groups (cols 0-3 <-> 5-8), keeping the
    strand column — reference bin/reformatPAF (src/reformatPAF.cpp:22-33)."""
    v = line.rstrip("\n").split("\t")
    out = [v[5], v[6], v[7], v[8], v[4], v[0], v[1], v[2], v[3]]
    out.extend(v[9:])
    return "\t".join(out)


def reformat_file(src_path: str, dst_path: str) -> None:
    with open(src_path) as src, open(dst_path, "w") as dst:
        for line in src:
            if line.strip():
                dst.write(reformat_line(line) + "\n")


def _external_sort(src_path: str, dst_path: str, keys: list,
                   tmpdir: str | None = None) -> bool:
    """Stable byte-collation sort via sort(1) — constant memory for
    arbitrarily large PAFs (the reference shells out the same way,
    CONSENT-polish:192).  Returns False if sort(1) is unavailable."""
    import shutil
    import subprocess

    if shutil.which("sort") is None:
        return False
    env = dict(os.environ, LC_ALL="C")
    cmd = ["sort", "--stable", "-t", "\t", *keys, src_path,
           "-o", dst_path]
    if tmpdir:
        cmd[1:1] = ["-T", tmpdir]
    subprocess.run(cmd, check=True, env=env)
    return True


def sort_by_target(src_path: str, dst_path: str) -> None:
    """Group a PAF by target name (column 6), stably — the polishing
    driver's `LC_COLLATE=C sort -k6,6` step (CONSENT-polish:192).

    Byte-wise (C-collation) comparison on the full 6th field only,
    stable within equal keys.  Shells out to sort(1) (constant memory,
    external merge) with an in-RAM fallback.
    """
    if _external_sort(src_path, dst_path, ["-k6,6"]):
        return
    with open(src_path) as f:
        lines = [ln for ln in f if ln.strip()]
    lines.sort(key=lambda ln: ln.split("\t")[5].encode())
    with open(dst_path, "w") as f:
        f.writelines(lines)


def group_paf_by_query(src_path: str, dst_path: str) -> None:
    """Make all overlaps of each query contiguous, preserving the order
    of first appearance of each query and the relative order of each
    query's lines — the explode+merge role for chunked-index PAFs
    (reference: src/explode.cpp + src/merge.cpp; the reference keys the
    output order on the reads-file header order, which coincides with
    first-appearance order for minimap2 all-vs-all output; unlike
    merge, this grouping is lossless when a query skips a chunk —
    see tests/test_reference_diff.py).

    Streaming: pass 1 prefixes each line with its query's
    first-appearance ordinal (only the name->ordinal map is held in
    RAM — a few bytes per read, vs. the whole PAF before); an external
    stable numeric sort(1) groups the lines; pass 2 strips the prefix.
    Falls back to one in-RAM pass without sort(1).
    """
    ordinals: dict = {}
    tagged = dst_path + ".tag"
    with open(src_path) as src, open(tagged, "w") as out:
        for line in src:
            if not line.strip():
                continue
            q = line.split("\t", 1)[0]
            o = ordinals.setdefault(q, len(ordinals))
            out.write(f"{o}\t{line}")
    tagged_sorted = dst_path + ".tagsorted"
    if _external_sort(tagged, tagged_sorted, ["-k1,1n"]):
        with open(tagged_sorted) as src, open(dst_path, "w") as out:
            for line in src:
                out.write(line.split("\t", 1)[1])
        os.unlink(tagged_sorted)
        os.unlink(tagged)
        return
    os.unlink(tagged)
    # fallback: one in-RAM pass
    from collections import OrderedDict

    groups: "OrderedDict[str, list]" = OrderedDict()
    with open(src_path) as f:
        for line in f:
            if not line.strip():
                continue
            q = line.split("\t", 1)[0]
            groups.setdefault(q, []).append(line)
    with open(dst_path, "w") as f:
        for lines in groups.values():
            f.writelines(lines)
