"""The torch port's CLI end to end on the CPU (``--device cpu``).

Exact precision is all-host native scoring and must reproduce the
reference golden outputs byte for byte; fast precision runs the slab
path through the port's plain torch kernels and must meet the fast
contract (utils.contract.diff_records) against the same goldens.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_port_util import filtered_lines  # noqa: E402

from somatic_sniper_tpu_torch.cli.main import main  # noqa: E402
from somatic_sniper_tpu_torch.ops import build  # noqa: E402
from somatic_sniper_tpu_torch.utils.contract import diff_records  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _run(tmp_path, args, tag="out"):
    out = tmp_path / tag
    assert main([*args, str(out)]) == 0
    return out


def _golden_args(data_dir):
    return ["-f", str(data_dir / "small.fa"), str(data_dir / "t-small.bam"),
            str(data_dir / "n-small.bam")]


def test_golden_pair_exact_bitwise(data_dir, tmp_path):
    out = _run(tmp_path, ["--device", "cpu", "--precision", "exact",
                          "-F", "vcf", *_golden_args(data_dir)])
    assert filtered_lines(out) == filtered_lines(data_dir / "expected.vcf")


def test_golden_pair_fast_contract(data_dir, tmp_path):
    out = _run(tmp_path, ["--device", "cpu", "--precision", "fast",
                          "-F", "vcf", *_golden_args(data_dir)])
    diff_records(filtered_lines(out),
                 filtered_lines(data_dir / "expected.vcf"), "vcf")


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("fmt", ["vcf", "classic"])
def test_sim1(data_dir, tmp_path, fmt, precision):
    d = data_dir / "e2e" / "sim1"
    out = _run(tmp_path, ["--device", "cpu", "--precision", precision,
                          "-F", fmt, "-f", str(d / "ref.fa"),
                          str(d / "tumor.bam"), str(d / "normal.bam")])
    got = filtered_lines(out)
    want = filtered_lines(d / f"expected.{fmt}")
    if precision == "exact":
        assert got == want
    else:
        diff_records(got, want, fmt)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_windowed_bytes_independent_of_window_size(data_dir, tmp_path,
                                                   precision):
    d = data_dir / "e2e" / "sim1"
    args = ["--device", "cpu", "--precision", precision, "-F", "vcf",
            "--shard-index", "0", "-f", str(d / "ref.fa"),
            str(d / "tumor.bam"), str(d / "normal.bam")]
    a = _run(tmp_path, [*args, "--window-size", "700"], "w700")
    b = _run(tmp_path, [*args, "--window-size", "250000"], "w250k")
    assert filtered_lines(a) == filtered_lines(b)
    assert len(filtered_lines(a)) > 10


@pytest.mark.parametrize("driver,precision", [
    ("whole", "fast"),
    ("windowed", "fast"),
    ("windowed", "exact"),
    ("whole-no-native", "fast"),
])
def test_cli_never_imports_jax(data_dir, tmp_path, driver, precision):
    """The CLI runs with ``import jax`` and ``import somatic_sniper_tpu``
    made impossible: the whole-file
    path on the golden pair (also with the native library missing, the
    pure-Python decode and u16 batch path), and the windowed driver (the
    path of any reference over 1.5 Mb) on sim1 in both precisions."""
    out = tmp_path / "nojax.vcf"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if driver == "whole-no-native":
        env["SNIPER_NATIVE_LIB"] = str(tmp_path / "missing.so")
    if driver.startswith("whole"):
        inputs, want = _golden_args(data_dir), data_dir / "expected.vcf"
    else:
        d = data_dir / "e2e" / "sim1"
        inputs = ["--shard-index", "0", "--window-size", "700",
                  "-f", str(d / "ref.fa"), str(d / "tumor.bam"),
                  str(d / "normal.bam")]
        want = d / "expected.vcf"
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['somatic_sniper_tpu'] = None\n"
            "from somatic_sniper_tpu_torch.cli.main import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    r = subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu", "--precision",
         precision, "-F", "vcf", *inputs, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    if precision == "exact":
        assert filtered_lines(out) == filtered_lines(want)
    else:
        diff_records(filtered_lines(out), filtered_lines(want), "vcf")


def test_device_cuda_without_cuda_exits_1(data_dir, tmp_path, monkeypatch,
                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.vcf"
    rc = main(["--precision", "fast", "-F", "vcf", *_golden_args(data_dir),
               str(out)])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("args,what", [
    (["--jobs", "2"], "--jobs"),
    (["--merge", "collective"], "--merge collective"),
])
def test_unported_options_exit_1(data_dir, tmp_path, capsys, args, what):
    """The options the port once refused with exit 1 (the test keeps its
    name) now run: ``--jobs 2`` spawns two shard workers and merges
    their outputs, ``--merge collective`` without a coordinator is a
    plain single-process run; both give sim1's golden bytes."""
    d = data_dir / "e2e" / "sim1"
    out = tmp_path / "x.vcf"
    rc = main([*args, "--device", "cpu", "-F", "vcf", "-f", str(d / "ref.fa"),
               str(d / "tumor.bam"), str(d / "normal.bam"), str(out)])
    assert rc == 0
    assert "not yet in the torch port" not in capsys.readouterr().err
    assert filtered_lines(out) == filtered_lines(d / "expected.vcf")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_build_is_keyed_by_sources_and_flags(monkeypatch):
    p1 = build.library_path()
    assert p1.parent == build.BUILD_DIR and p1.name.endswith(".so")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path() != p1
