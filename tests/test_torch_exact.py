"""The port's exact (f64) glfgen and the paths that score with it.

``glfgen_batch(precision="exact")`` must equal the reference column
oracle (``tests/data/glf_oracle_*.bin``) and the JAX package's exact
path bit for bit; ``call_batch(precision="exact")`` the JAX one field
for field; and the port's CLI with the native library missing must
print the golden bytes.  No tolerance anywhere.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.fixtures_util import (columns_to_batch, read_columns,  # noqa: E402
                                 read_glf_oracle)
from tests.torch_port_util import (filtered_lines, port_params,  # noqa: E402
                                   random_u32, to_packed16)

from somatic_sniper_tpu.models import glfgen as jg  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as tg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.consensus import glf2cns_batch  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    build_tables, device_tables)
from somatic_sniper_tpu_torch.parallel import sharded  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CASES = {
    "default": dict(theta=0.85, het_rate=0.001, n_hap=2),
    "theta99": dict(theta=0.99, het_rate=0.001, n_hap=2),
    "nhap4": dict(theta=0.85, het_rate=0.002, n_hap=4),
}


def _port_batch(slots, depth, ref16):
    return tg.ColumnBatch(
        slots=torch.from_numpy(np.ascontiguousarray(slots).view(np.int32)),
        depth=torch.from_numpy(depth), ref16=torch.from_numpy(ref16))


def _jax_batch(slots, depth, ref16):
    return jg.ColumnBatch(slots=jnp.asarray(slots), depth=jnp.asarray(depth),
                          ref16=jnp.asarray(ref16))


def _exact_tables(jparams):
    return device_tables(build_tables(port_params(jparams)), CPU, "exact")


@pytest.mark.parametrize("case", list(CASES))
def test_glfgen_exact_matches_oracle_and_jax(data_dir, case):
    """As tests/test_glfgen.py::test_glfgen_exact_matches_oracle, on the
    same two depth buckets, and against the JAX package's result."""
    cols = read_columns(data_dir / "glf_columns_in.bin")
    oracle = read_glf_oracle(data_dir / f"glf_oracle_{case}.bin")
    jparams = T.ModelParams(**CASES[case])
    tabs = T.build_tables(jparams)
    dtabs = _exact_tables(jparams)
    assert dtabs.fk.dtype == dtabs.coef.dtype == dtabs.lhet.dtype \
        == torch.float64
    depths = np.array([len(r) for _, r in cols])
    seen = 0
    for idx, pad in ((np.nonzero(depths <= 64)[0], 64),
                     (np.nonzero(depths > 64)[0], 1280)):
        b = columns_to_batch([cols[i] for i in idx], max_depth=pad)
        args = (b["slots"], b["n_total"], b["ref16"])
        g = tg.glfgen_batch(_port_batch(*args), dtabs, 60, "exact")
        want = jg.glfgen_batch(_jax_batch(*args), tabs.fk, tabs.coef,
                               tabs.lhet, precision="exact")
        o = oracle[idx]
        for name, key in (("lk", "lk"), ("min_lk", "min_lk"),
                          ("depth", "depth"), ("rms_mapq", "rms")):
            got = getattr(g, name).numpy()
            np.testing.assert_array_equal(got, o[key], err_msg=name)
            np.testing.assert_array_equal(
                got, np.asarray(getattr(want, name)), err_msg=name)
        cns = glf2cns_batch(g.lk, torch.from_numpy(b["n_total"]),
                            dtabs.q_r_int)
        packed = (cns.base1.numpy().astype(np.uint32) << 28
                  | cns.base2.numpy().astype(np.uint32) << 24
                  | g.rms_mapq.numpy().astype(np.uint32) << 16
                  | cns.score1.numpy().astype(np.uint32) << 8
                  | cns.score2.numpy().astype(np.uint32))
        np.testing.assert_array_equal(packed, o["cns"])
        seen += len(idx)
    assert seen == len(cols) == 4000


def test_pack_info_matches_jax():
    slots, depth, ref16 = random_u32(300, 40, seed=3)
    key, n = tg.pack_info(_port_batch(slots, depth, ref16))
    key_j, n_j = jg.pack_info(_jax_batch(slots, depth, ref16))
    assert key.dtype == torch.int64
    np.testing.assert_array_equal(key.numpy().astype(np.uint32),
                                  np.asarray(key_j))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    # the int64 keys sort as the uint32 ones do
    np.testing.assert_array_equal(
        torch.sort(key, dim=1).values.numpy().astype(np.uint32),
        np.sort(np.asarray(key_j), axis=1))


@pytest.mark.parametrize("B,D,use_joint", [
    (256, 40, False), (256, 40, True), (48, 300, False), (5, 1, True),
], ids=["solo", "joint", "deeper-than-255", "depth-1"])
def test_call_batch_exact_matches_jax(B, D, use_joint):
    """Every field of CallResult equal, the c_tot > 255 rescale
    included (D = 300 with columns filled to the top)."""
    s_t, d_t, ref16 = random_u32(B, D, seed=40 + D)
    s_n, d_n, _ = random_u32(B, D, seed=41 + D)
    if D > 255:
        d_t[:8] = D
        s_t[:8] = random_u32(8, D, seed=1)[0] | (30 << 8) | 40
        s_t[:8] &= ~np.uint32(1 << 21)
    jparams = T.ModelParams(use_joint_priors=use_joint,
                            somatic_mutation_rate=0.001, min_somatic_qual=0)
    tabs = T.build_tables(jparams)
    want = js.call_batch(
        _jax_batch(s_t, d_t, ref16), _jax_batch(s_n, d_n, ref16), tabs.fk,
        tabs.coef, tabs.lhet, tabs.solo_prior, tabs.joint_prior, tabs.qadd,
        tabs.q_r_int, precision="exact", use_joint=use_joint,
        min_somatic_qual=0, cap_mapq=jparams.cap_mapq)
    params = port_params(jparams)
    got = ts.call_batch(_port_batch(s_t, d_t, ref16),
                        _port_batch(s_n, d_n, ref16),
                        _exact_tables(jparams), params, "exact")
    assert got.tumor_dq is None and want.tumor_dq is None
    for f in js.COMPACT_FIELDS + ("emit",):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if B > 100:
        assert int(got.emit.sum()) > B // 8
    if D > 255:
        assert int(got.tumor_depth.max()) > 255


def test_exact_reads_full_slot_words_only():
    slots, depth, ref16 = random_u32(8, 16, seed=5)
    s16, nk, rms = to_packed16(slots, depth, ref16)
    jparams = T.ModelParams()
    u16 = tg.ColumnBatch(slots=torch.from_numpy(s16),
                         depth=torch.from_numpy(depth),
                         ref16=torch.from_numpy(ref16),
                         n_keep=torch.from_numpy(nk),
                         rms_sum=torch.from_numpy(rms))
    with pytest.raises(ValueError, match="u32 slot encoding"):
        tg.glfgen_batch(u16, _exact_tables(jparams), 60, "exact")
    fast = device_tables(build_tables(port_params(jparams)), CPU)
    assert fast.precision == "fast" and fast.coef.dtype == torch.float32
    assert not hasattr(fast, "fk")
    with pytest.raises(ValueError, match="fast tables"):
        tg.glfgen_batch(_port_batch(slots, depth, ref16), fast, 60, "exact")
    with pytest.raises(ValueError, match="exact tables"):
        tg.glfgen_batch(_port_batch(slots, depth, ref16),
                        _exact_tables(jparams), 60, "fast")


def _cli_without_native(tmp_path, fmt, inputs, tag):
    out = tmp_path / f"{tag}.{fmt}"
    env = dict(os.environ, SNIPER_NATIVE_LIB="/nonexistent")
    r = subprocess.run(
        [sys.executable, "-m", "somatic_sniper_tpu_torch.cli.main",
         "--device", "cpu", "--precision", "exact", "--stats", "-F", fmt,
         *inputs, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    # the run decoded in pure Python and scored batches, not the native
    # scorer
    assert "batches_dispatched" in r.stderr and "decode" in r.stderr
    return out


@pytest.mark.parametrize("fmt", ["vcf", "classic", "bed"])
def test_cli_exact_without_native_library(data_dir, tmp_path, fmt):
    """vcf against the golden file; classic and bed against the port's
    own native exact run."""
    from somatic_sniper_tpu_torch.cli.main import main

    inputs = ["-f", str(data_dir / "small.fa"), str(data_dir / "t-small.bam"),
              str(data_dir / "n-small.bam")]
    got = _cli_without_native(tmp_path, fmt, inputs, "nonative")
    if fmt == "vcf":
        assert filtered_lines(got) == filtered_lines(
            data_dir / "expected.vcf")
    native = tmp_path / f"native.{fmt}"
    assert main(["--device", "cpu", "--precision", "exact", "-F", fmt,
                 *inputs, str(native)]) == 0
    assert filtered_lines(got) == filtered_lines(native)
    assert len(filtered_lines(got)) >= 3


def test_cli_exact_without_native_library_sim1(data_dir, tmp_path):
    d = data_dir / "e2e" / "sim1"
    got = _cli_without_native(
        tmp_path, "vcf", ["-f", str(d / "ref.fa"), str(d / "tumor.bam"),
                          str(d / "normal.bam")], "sim1")
    assert filtered_lines(got) == filtered_lines(d / "expected.vcf")


def test_windowed_exact_without_reference_takes_the_batch_path(data_dir):
    """No reference: the native exact scorer does not apply, the window
    goes through exact full-u32 batches, and every site is gated out by
    ref16 = 15, as in the JAX package."""
    d = data_dir / "e2e" / "sim1"
    STATS.reset()
    lines = [ln for _wi, _w, out in sharded.call_pair_windows(
        str(d / "tumor.bam"), str(d / "normal.bam"), None, "vcf",
        precision="exact", window_size=2000, device=CPU) for ln in out]
    assert lines == []
    assert STATS.snapshot().get("batches_dispatched", 0) > 0
    with pytest.raises(ValueError, match="needs a device"):
        list(sharded.call_pair_windows(
            str(d / "tumor.bam"), str(d / "normal.bam"), None, "vcf",
            precision="exact"))
