"""Pipeline configuration.

One dataclass with two presets mirroring the reference's *effective*
defaults — the bash drivers override the binary defaults, and the scripts
are the source of truth (reference: CONSENT-correct:42-52 vs
src/main.cpp:17-26; CONSENT-polish:42-52).

Notable discrepancies preserved here (documented in SURVEY.md §5):
  * correct: minSupport=3, maxSupport=150 (script) — binary says 1000.
  * polish:  minSupport=1, maxSupport=20000.
  * minAnchors: script passes 2, binary default is 10 — effective is 2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ConsentConfig:
    """All tunables of the correction/polishing pipeline."""

    # --- reference-equivalent knobs (CONSENT-correct:42-52) ---
    min_support: int = 3          # min coverage for a window (-s)
    max_support: int = 150        # max overlaps kept per pile (-S)
    max_msa: int = 150            # max sequences entering consensus (-M)
    window_size: int = 500        # template window length (-l)
    mer_size: int = 9             # k for counting/anchoring/polish (-k)
    common_kmers: int = 8         # anchor support threshold (-c)
    min_anchors: int = 2          # min anchors to attempt consensus (-A)
    solid_thresh: int = 4         # k-mer solidity threshold (-f)
    window_overlap: int = 50      # overlap of consecutive windows (-m)

    # --- trimming behavior (reference: CONSENT-correction.cpp:17 vs
    #     CONSENT-polishing.cpp:19; -R proofFile disables trimming) ---
    trim: bool = True

    # --- DBG polish budgets (reference: correctionDBG.cpp:100-102,163) ---
    max_branches: int = 50
    dbg_zone: int = 3

    # --- TPU-native knobs (no reference equivalent) ---
    # Extra bases a clipped fragment may carry beyond window_size
    # (target-side insertions make fragments slightly longer).
    frag_slack: int = 140
    # Max alignment lanes (windows x fragment slots) per device
    # consensus call, per device — the device batch geometry knob.
    # Large calls amortize per-call dispatch/fetch latency (each window
    # round-trips its packed votes to the host exactly once).
    device_lanes: int = 4096
    # Scoring of the device CONSENSUS aligner (realign-vote; tuned for
    # CLR error profiles, no reference equivalent — the reference's
    # consensus is SPOA inside BMEAN).  The stitcher does NOT use
    # these: it has its own STITCH_SCORING mirroring the reference's
    # SSW defaults (pipeline/stitch.py:34, correctionAlignment.cpp:48).
    match_score: int = 2
    mismatch_score: int = -4
    gap_open: int = 4
    gap_extend: int = 2
    # Consensus refinement rounds (realign fragments to the previous
    # round's consensus).  With the run-conservation indel votes the
    # second round compounds: window-level identity on simulated CLR
    # (S=12, 10% error) measures 0.9806 (1 round) -> 0.9933 (2) ->
    # 0.9931 (3), so the default is 2; drop to 1 for ~2x window
    # throughput at ~1.3pp identity cost.
    consensus_rounds: int = 2
    # Fragment-slot fraction used by the WARM refinement rounds (all
    # rounds except the last).  The warm rounds only produce the next
    # round's template; the engine fills slots best-match-first, so a
    # fraction < 1 realigns just the top fragments while the FINAL
    # vote round keeps full depth.  Refpoint decision matrix
    # (benchmarks/warm_matrix.py, read-level identity at the
    # reference's 500/50 windowing, 24 piles, PB 10% / ONT 12%
    # indel-heavy; throughput from benchmarks/rounds2_sweep.py):
    #   rounds=2 warm=1.0:  0.9965 / 0.9891   (6.6x baseline)
    #   rounds=2 warm=0.5:  0.9969 / 0.9886   (8.4x)
    #   rounds=2 warm=0.25: 0.9961 / 0.9876   (9.7x)  <- default
    #   rounds=1:           -0.5 / -0.9 pp vs rounds=2
    # 0.25 is accuracy-neutral on PB (within the matrix's 0.05-pp
    # noise) and costs 0.15 pp on the indel-heavy ONT profile, so the
    # CLI keeps warm_frac=0.5 for --type ONT (cli._cfg_from_args) the
    # same way the reference specializes its overlapper per
    # technology (CONSENT-correct:185-187).  1.0 = disabled.
    warm_frac: float = 0.25
    # Horizontal-gap cap for the consensus aligner (0 = exact); longer
    # template deletions route through mismatches and are repaired by
    # the DBG stage.  Shrinks the kernel's per-row scan.
    consensus_max_hgap: int = 16
    # Diagonal band width for the consensus aligner (0 = full DP).
    # Fragments are near-diagonal (each lane's expected offset d0 is
    # estimated from the PAF span ratio at clip time), so a 128-wide
    # band loses nothing and cuts the kernel's per-row vector width
    # from the window length to the band.  Multiple of 128.
    consensus_band: int = 128
    # Min plurality coverage for a consensus column to override template.
    min_column_support: int = 2

    # --- runtime ---
    # Local devices the engine shards window batches over (shard_map
    # over the `data` mesh axis); None = all local devices.
    n_devices: Optional[int] = None
    # Devices of the `frag` mesh axis: fragment slots of each window
    # shard across devices and the vote reductions become psum
    # all-reduces (parallel/mesh.py) — the deep-pile geometry (polish
    # piles reach maxSupport=20000).  None = auto: enabled when the
    # fragment-slot demand (max_msa + 1) exceeds device_lanes, i.e.
    # one window's fragments no longer fit one device's lane budget.
    frag_devices: Optional[int] = None
    # Host-side worker threads for the CPU stages (k-mer counting,
    # DBG polish, stitch apply) — the TPU-side analogue of the
    # reference's -j sizing its CTPL pool (CONSENT-correction.cpp:77).
    # None = os.cpu_count().  Wired to the CLI's --nproc/-j.
    n_workers: Optional[int] = None

    @property
    def frag_len(self) -> int:
        """Fixed device-side fragment length (window + slack)."""
        return self.window_size + self.frag_slack

    @property
    def n_kmers(self) -> int:
        return 4 ** self.mer_size

    def validate(self) -> "ConsentConfig":
        if self.window_overlap >= self.window_size:
            raise ValueError("window_overlap must be < window_size")
        if self.mer_size < 2 or self.mer_size > 15:
            raise ValueError("mer_size must be in [2, 15]")
        if self.min_support < 1:
            raise ValueError("min_support must be >= 1")
        if self.device_lanes < 1:
            raise ValueError("device_lanes must be >= 1")
        if self.max_branches < 0 or self.dbg_zone < 0:
            raise ValueError("max_branches/dbg_zone must be >= 0")
        if self.max_msa >= 30000:
            # the device vote reductions accumulate per-column counts
            # in int16 (ops/consensus.py red()); counts are bounded by
            # the fragment-slot cap max_msa + 1, so -M must stay well
            # under 2^15 or the accumulator silently overflows
            raise ValueError(
                "max_msa must be < 30000 (int16 vote accumulators)"
            )
        return self


def correct_preset(**overrides) -> ConsentConfig:
    """Self-correction defaults (reference: CONSENT-correct:42-52)."""
    return dataclasses.replace(
        ConsentConfig(
            min_support=3,
            max_support=150,
            trim=True,
        ),
        **overrides,
    ).validate()


def polish_preset(**overrides) -> ConsentConfig:
    """Assembly-polishing defaults (reference: CONSENT-polish:42-52).

    Contigs are never trimmed/dropped (reference:
    CONSENT-polishing.cpp:19 doTrimRead=false).
    """
    return dataclasses.replace(
        ConsentConfig(
            min_support=1,
            max_support=20000,
            trim=False,
        ),
        **overrides,
    ).validate()


def from_reference(d: dict) -> ConsentConfig:
    """Build this package's config from a JAX-package config given as a
    plain dict (dataclasses.asdict).  The field sets must agree, so a
    knob added on one side only fails here instead of being dropped."""
    names = {f.name for f in dataclasses.fields(ConsentConfig)}
    if set(d) != names:
        raise ValueError(
            f"config fields differ: {sorted(set(d) ^ names)}"
        )
    return ConsentConfig(**d).validate()
