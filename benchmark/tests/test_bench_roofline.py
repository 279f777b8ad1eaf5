"""The byte count of step_roofline_pct on a hand-worked case."""

from __future__ import annotations

import sys

from bench_util import HERE

sys.path.insert(0, str(HERE))
import roofline  # noqa: E402


def test_column_bytes_by_hand():
    # 30x a sample: 2 samples x 30 lanes x 4 B = 240, + 1 reference byte,
    # + 52 int32 output values = 208 -> 449 B a column
    assert roofline.column_bytes(30.0) == 449.0
    # 126,350 columns (a 10 Mb pass's card columns, PERF.md section 5)
    # move 56.73 MB: 16.93 us at 3.35 TB/s
    s = roofline.bound_seconds(126_350, 30.0)
    assert abs(s - 126_350 * 449 / 3.35e12) < 1e-15
    assert abs(s - 16.934e-6) < 0.001e-6


def test_count_ignores_the_slab_shape():
    # a deeper pair costs 8 B more a column per unit of depth, nothing else
    assert roofline.column_bytes(101.0) - roofline.column_bytes(100.0) == 8.0
