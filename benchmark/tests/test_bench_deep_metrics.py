"""The readers of the deep tiers' metrics: each gives its value from a
run's ``STATS`` deltas or trace breakdown, and ``None`` where the
program has no such counter or kernel (a program that predates them)."""

from __future__ import annotations

import importlib.util
import sys
from types import SimpleNamespace

import pytest

from bench_util import HERE

sys.path.insert(0, str(HERE))

import roofline  # noqa: E402

STATS = {"device_columns": 8192 * 3, "device_columns_deep": 8192 * 2,
         "slab_bytes_uploaded": 3 * (2 * 8192 * 384 * 4 + 3 * 8192 * 4)}
COLUMNS = 40_000
OPS = [["_anonymous_namespace_::bgzf_inflate_kernel_unsigned_char_const__",
        9.0],
       ["Memcpy_HtoD__Pinned_-__Device_", 0.5],
       ["void__anonymous_namespace_::accumulate_kernel_0__int_const___in",
        0.002],
       ["void__anonymous_namespace_::score_columns_kernel_false__true___a",
        0.0005],
       ["void__anonymous_namespace_::assembly10_kernel_float_const___flo",
        0.0002],
       ["void__anonymous_namespace_::glfgen32_kernel_64__int_const___int_",
        0.0003],
       ["void_at::native::vectorized_elementwise_kernel_4__at::native::AU",
        0.001]]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# the scoring step's device seconds in OPS: every entry but the inflate
# and the copy
STEP_S = 0.002 + 0.0005 + 0.0002 + 0.0003 + 0.001


def _run(stats=STATS, ops=OPS, unlisted=0.0):
    return SimpleNamespace(columns=COLUMNS, stats=dict(stats),
                           breakdown={"device_ops": ops, "idle_gaps": []},
                           device_op_s=sum(s for _, s in ops) + unlisted,
                           pair=SimpleNamespace(mean_depth=300.0))


def test_deep_card_pct():
    assert _reader("deep_card_pct")(_run()) == pytest.approx(
        100.0 * 8192 * 2 / COLUMNS)


def test_upload_bytes_col():
    assert _reader("upload_bytes_col")(_run()) == pytest.approx(
        2 * 384 * 4 + 3 * 4)


def test_score_roofline_pct_counts_the_step_without_inflate_and_copies():
    want = 100.0 * roofline.bound_seconds(8192 * 3, 300.0) / STEP_S
    assert _reader("score_roofline_pct")(_run()) == pytest.approx(want)


@pytest.mark.parametrize("name,gone", [
    ("deep_card_pct", "device_columns_deep"),
    ("upload_bytes_col", "slab_bytes_uploaded"),
    ("upload_bytes_col", "device_columns"),
    ("score_roofline_pct", "device_columns")])
def test_reader_none_without_its_counter(name, gone):
    stats = {k: v for k, v in STATS.items() if k != gone}
    assert _reader(name)(_run(stats)) is None


def test_score_roofline_counts_what_the_breakdown_leaves_out():
    """Device time outside the breakdown's ten operations is the step's
    too (its smaller kernels, the rescale's among them): it lowers the
    share; without the window's summed device time there is no share."""
    read = _reader("score_roofline_pct")
    ops = OPS + [[f"void_at::native::other_kernel_{i}", 0.0001]
                 for i in range(3)]
    run = _run(ops=ops, unlisted=0.0004)
    want = 100.0 * roofline.bound_seconds(8192 * 3, 300.0) / (
        STEP_S + 0.0003 + 0.0004)
    assert read(run) == pytest.approx(want)
    del run.device_op_s
    assert read(run) is None


def test_score_roofline_none_without_a_scoring_kernel():
    read = _reader("score_roofline_pct")
    assert read(_run(ops=OPS[:2])) is None
    assert read(SimpleNamespace(columns=COLUMNS, stats=dict(STATS))) is None
