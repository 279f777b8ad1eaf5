"""The torch port's CUDA kernels on the card, against their plain torch
versions on the same inputs.

Marked ``cuda``: every test skips without a CUDA device.  On a machine
with one card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)

Tolerances as in the CPU tests: c/rms and the assembly exact, the f32
class sums within rtol 1e-6, atol 1e-5 (summation order), the u8 rows
within the fast contract.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_port_util import (filtered_lines,  # noqa: E402
                                   random_raw32, random_slab)

from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.utils.contract import diff_records  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import device_tables  # noqa: E402
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402

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


@pytest.mark.parametrize("B,D", [(8192, 48), (300, 16), (1024, 255)])
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
