"""Peaks of one H100 and the work of the posterior-alignment kernels.

Copied from chip_smoke.py (its roofline arithmetic): the integer-ALU
issue rate that probes/int_rate.py measured on the card, the HBM rate
of the data sheet, and `alu_per_cell`, the ALU-pipe instructions one
DP cell needs over both passes with DPX."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
INT32_OPS_PER_S = 132 * 64 * 1.98e9       # 132 SMs x 64 lanes x 1.98 GHz


def alu_per_cell(max_hgap: int) -> int:
    """ALU instructions of one DP cell, forward and backward: 5 each
    plus the horizontal-gap max, one running max with exact gaps and
    ceil(log3(window)) 3-way maxes when gaps are capped."""
    if not max_hgap:
        return 2 * (5 + 1)
    window = 1 << math.ceil(math.log2(max_hgap))
    return 2 * (5 + math.ceil(math.log(window, 3) - 1e-9))


def full_width_work(q_len: int, r_len: int, width: int):
    """(ALU instructions, bytes) one full-width lane needs: q_len x r_len
    cells (halved for the one-warp-per-lane design, two int16 cells per
    packed instruction, templates up to 1,024 columns); its query,
    reference and two lengths in, its score and five per-column outputs
    (matched, i_first, i_last, base, ins_pack: 17 bytes) out."""
    ops = alu_per_cell(0) * q_len * r_len
    if width <= 1024:
        ops //= 2
    return ops, q_len + r_len + 8 + 4 + 17 * r_len


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
