"""The torch port's CUDA kernels on the card, against their plain torch
versions on the same inputs.

Marked ``cuda``: every test skips without a CUDA device.  On a machine
with one card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use; they import the port alone.)

Tolerances as in the CPU tests: c/rms and the assembly exact, the f32
class sums within rtol 1e-6, atol 1e-5 (summation order), the rows
within the fast contract.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_port_util import (filtered_lines,  # noqa: E402
                                   hazard_column, random_raw32, random_slab,
                                   random_stacked, random_u32, to_packed16)

from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import device_tables  # noqa: E402
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.utils.contract import diff_records  # noqa: E402

pytestmark = pytest.mark.cuda
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    from somatic_sniper_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _lanes(B, D, seed, dev):
    slots, nk, _, ref16 = random_raw32(B, D, seed)
    return (torch.from_numpy(slots.view(np.int32)).to(dev),
            torch.from_numpy(nk).to(dev), torch.from_numpy(ref16).to(dev))


@pytest.mark.parametrize("B,D", [(8192, 48), (300, 16), (257, 100),
                                 (1024, 255)])
def test_kernels_match_plain_on_card(dev, B, D):
    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    s, nk, r = _lanes(B, D, D, dev)
    before = dict(gk.LAUNCHES)
    k = gk.accumulate32(s, nk, r, dtabs.fk_weights, 60)
    p = gk.accumulate32_plain(s, nk, r, dtabs.fk_weights, 60)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    torch.testing.assert_close(k[0], p[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(k[1], p[1], rtol=1e-6, atol=1e-5)
    args = (k[0], k[1], k[2], nk, *dtabs.assembly_tables(D))
    lk, mlk = gk.assembly10(*args)
    lk_p, mlk_p = gk.assembly10_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)
    assert gk.LAUNCHES["accumulate32"] == before["accumulate32"] + 1
    assert gk.LAUNCHES["assembly10"] == before["assembly10"] + 1
    # fixed-order sums: a second launch gives the same bits
    k2 = gk.accumulate32(s, nk, r, dtabs.fk_weights, 60)
    assert all(torch.equal(a, b) for a, b in zip(k, k2))


@pytest.mark.parametrize("shift", [5, -1])
def test_assembly10_card_rejects_counts_past_the_table(dev, shift):
    """Counts that would index past coef_sub/lhet_sub raise on the card as
    on the CPU, and the kernel reads no table for them."""
    B, NK = 300, 17
    e = torch.zeros((B, 4), device=dev)
    c = torch.full((B, 4), shift, dtype=torch.int32, device=dev)
    c[:-1] = 0  # one offending column among good ones
    n = torch.ones(B, dtype=torch.int32, device=dev)
    tabs = (torch.zeros((60, NK, NK), device=dev),
            torch.zeros((NK, NK), device=dev))
    with pytest.raises(ValueError, match="table depth"):
        gk.assembly10(e, e, c, n, *tabs)
    with pytest.raises(ValueError, match="table depth"):
        gk.assembly10_plain(e, e, c, n, *tabs)
    torch.cuda.synchronize()  # no sticky fault from the kernel


def test_call_batch_packed_card_matches_cpu(dev):
    B, D = 2048, 48
    stacked, meta = random_slab(B, D, seed=3)
    params = T.ModelParams(min_somatic_qual=0)
    tabs = T.build_tables(params)
    res = {}
    for d in (torch.device("cpu"), dev):
        out = ts.call_batch_packed(
            torch.from_numpy(stacked.view(np.int32)).to(d),
            torch.from_numpy(meta).to(d), device_tables(tabs, d), params)
        res[d.type] = (int(out.count), out.rows.cpu().numpy().astype(int))
    (n_c, rows_c), (n_g, rows_g) = res["cpu"], res["cuda"]
    assert n_c == n_g > 0
    assert np.abs(rows_c[:n_c] - rows_g[:n_c]).max() <= 1
    assert (rows_c[:n_c] == rows_g[:n_c]).all(axis=1).mean() >= 0.99


def test_cli_fast_on_card_golden(dev, tmp_path):
    from somatic_sniper_tpu_torch.cli.main import main

    out = tmp_path / "out.vcf"
    assert main(["--precision", "fast", "--device", "cuda", "-F", "vcf",
                 "-f", str(DATA / "small.fa"), str(DATA / "t-small.bam"),
                 str(DATA / "n-small.bam"), str(out)]) == 0
    diff_records(filtered_lines(out), filtered_lines(DATA / "expected.vcf"),
                 "vcf")


def _assert_sums(k, p, D):
    rtol = 1e-6 if D <= 255 else 1e-4
    torch.testing.assert_close(k[0], p[0], rtol=rtol, atol=1e-5)
    torch.testing.assert_close(k[1], p[1], rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("B,D", [(4096, 16), (300, 48), (257, 128),
                                 (64, 1024), (2, 20000), (1001, 31),
                                 (1001, 33), (517, 65), (131, 129),
                                 (67, 255), (3, 1)])
def test_rank_kernels_match_plain_on_card(dev, B, D):
    """accumulate and accumulate16 against their plain versions at every
    layout: a warp a column with 1, 2, 4 and 8 keys a lane (P = 32 .. 256,
    at the depths on both sides of each step, and at B that fills no whole
    block), a block a column with keys in shared memory, and with keys in
    the global scratch (D > 16384)."""
    w = device_tables(T.build_tables(T.ModelParams()), dev).fk_weights
    slots, depth, ref16 = random_u32(B, D, D)
    depth[0] = D  # one full column
    s16, nk, _ = to_packed16(slots, depth, ref16)
    s, dp, r = (torch.from_numpy(a).to(dev)
                for a in (slots.view(np.int32), depth, ref16))
    before = dict(gk.LAUNCHES)
    k = gk.accumulate(s, dp, r, w, 60)
    p = gk.accumulate_plain(s, dp, r, w, 60)
    for a, b in zip(k[2:], p[2:]):
        assert torch.equal(a, b)
    _assert_sums(k, p, D)
    s16_d, nk_d = torch.from_numpy(s16).to(dev), torch.from_numpy(nk).to(dev)
    k16 = gk.accumulate16(s16_d, nk_d, w)
    p16 = gk.accumulate16_plain(s16_d, nk_d, w)
    torch.cuda.synchronize()
    assert torch.equal(k16[2], p16[2])
    _assert_sums(k16, p16, D)
    assert gk.LAUNCHES["accumulate"] == before["accumulate"] + 1
    assert gk.LAUNCHES["accumulate16"] == before["accumulate16"] + 1
    # fixed-order sums: a second launch gives the same bits
    k2 = gk.accumulate(s, dp, r, w, 60)
    assert all(torch.equal(a, b) for a, b in zip(k, k2))
    k16_2 = gk.accumulate16(s16_d, nk_d, w)
    assert all(torch.equal(a, b) for a, b in zip(k16, k16_2))


@pytest.mark.parametrize("packed16", [True, False])
def test_call_batch_stacked_card_matches_cpu(dev, packed16):
    """The batch path's i32 rows on the card against the CPU (plain
    kernels): same count, rows within the fast contract."""
    B, D = 4096, 40
    stacked, meta = random_stacked(B, D, 5, packed16)
    params = T.ModelParams(min_somatic_qual=0)
    tabs = T.build_tables(params)
    s = stacked if packed16 else stacked.view(np.int32)
    res = {}
    for d in (torch.device("cpu"), dev):
        out = ts.call_batch_stacked(
            torch.from_numpy(s).to(d), torch.from_numpy(meta).to(d),
            device_tables(tabs, d), params, packed16=packed16, max_emit=B)
        res[d.type] = (int(out.count), out.rows.cpu().numpy().astype(int))
    (n_c, rows_c), (n_g, rows_g) = res["cpu"], res["cuda"]
    assert n_c == n_g > 0
    assert np.abs(rows_c[:n_c] - rows_g[:n_c]).max() <= 1
    assert (rows_c[:n_c] == rows_g[:n_c]).all(axis=1).mean() >= 0.99


def test_cli_fast_on_card_without_native_golden(dev, tmp_path, monkeypatch):
    """The whole-file CLI with the native loaders switched off: pure-
    Python decode, u16 batches through accumulate16 on the card."""
    from somatic_sniper_tpu_torch.cli.main import main
    from somatic_sniper_tpu_torch.io import native_api

    monkeypatch.setattr(native_api, "available", lambda: False)
    gk.reset_launches()
    out = tmp_path / "out.vcf"
    assert main(["--precision", "fast", "--device", "cuda", "-F", "vcf",
                 "-f", str(DATA / "small.fa"), str(DATA / "t-small.bam"),
                 str(DATA / "n-small.bam"), str(out)]) == 0
    assert gk.LAUNCHES["accumulate16"] > 0
    assert gk.LAUNCHES["accumulate32"] == 0
    diff_records(filtered_lines(out), filtered_lines(DATA / "expected.vcf"),
                 "vcf")


def test_accumulate_card_ranks_by_raw_eff(dev):
    """The hazard column on the card: the kernel follows the reference's
    raw-eff rank (esum[A] = 35.4868), not the Pallas kernel's floored
    one (35.610474)."""
    w = device_tables(T.build_tables(T.ModelParams()), dev).fk_weights
    slots, depth, ref16 = hazard_column()
    s, dp, r = (torch.from_numpy(a).to(dev)
                for a in (slots.view(np.int32), depth, ref16))
    k = gk.accumulate(s, dp, r, w, 60)
    p = gk.accumulate_plain(s, dp, r, w, 60)
    torch.cuda.synchronize()
    assert torch.equal(k[2], p[2]) and torch.equal(k[4], p[4])
    _assert_sums(k, p, 3)
    assert abs(float(k[0][0, 0]) - 35.4868) < 1e-4
