"""Peaks of the card and the byte count of the work the card does.

``step_roofline_pct`` counts the work, not the implementation: a column
the card scores reads each kept read of both samples once, as one 4-byte
lane (base, qualities, strand), one reference byte, and writes one output
row: the 16 call fields and the two samples' 18 dqstats fields, 52
int32 values.  The depth is the generated pair's mean kept depth a
sample.  Neither the slab's padded shape nor any kernel enters the
count.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
LANE_BYTES = 4
REF_BYTES = 1
OUT_ROW_BYTES = 4 * (16 + 2 * 18)


def column_bytes(mean_depth: float) -> float:
    """Least bytes one scored column moves."""
    return 2 * mean_depth * LANE_BYTES + REF_BYTES + OUT_ROW_BYTES


def bound_seconds(columns: int, mean_depth: float) -> float:
    """Least time the card needs to score ``columns`` columns."""
    return columns * column_bytes(mean_depth) / PEAK_HBM_BYTES_PER_S
