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


def _sim1_windowed(data_dir):
    d = data_dir / "e2e" / "sim1"
    return (["--shard-index", "0", "--window-size", "700", "-f",
             str(d / "ref.fa"), str(d / "tumor.bam"), str(d / "normal.bam")],
            d / "expected.vcf")


@pytest.mark.parametrize("driver", ["whole", "windowed", "jobs"])
def test_exact_default_device_needs_no_card(data_dir, tmp_path, monkeypatch,
                                            driver):
    """The default run (``--precision exact``, ``--device cuda``) is
    scored by the native host layer and resolves no device: on a machine
    without a card it exits 0 with the golden bytes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    if driver == "whole":
        inputs, want = _golden_args(data_dir), data_dir / "expected.vcf"
    else:
        inputs, want = _sim1_windowed(data_dir)
        if driver == "jobs":
            inputs = ["--jobs", "2", *inputs[2:]]
    out = _run(tmp_path, ["-F", "vcf", *inputs])
    assert filtered_lines(out) == filtered_lines(want)


@pytest.mark.parametrize("driver", ["whole", "windowed"])
def test_fast_default_device_without_a_card_exits_1(data_dir, tmp_path,
                                                    monkeypatch, capsys,
                                                    driver):
    """Fast precision needs the device for certain: the run stops before
    the output is opened, on either driver."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs = (_golden_args(data_dir) if driver == "whole"
              else _sim1_windowed(data_dir)[0])
    out = tmp_path / "never.vcf"
    assert main(["--precision", "fast", "-F", "vcf", *inputs, str(out)]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device is available" in err and "--device cpu" in err
    assert not out.exists()


def test_exact_without_native_needs_the_device(data_dir, tmp_path,
                                               monkeypatch, capsys):
    """Exact precision without the native library scores batches on the
    device: with the default device and no card the run exits 1 where
    it first needs it (after the decode), and nothing runs on the CPU."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.io import native_api
    from somatic_sniper_tpu_torch.utils.stats import STATS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(native_api, "available", lambda: False)
    monkeypatch.setattr(
        runner, "submit_batches",
        lambda *a, **k: pytest.fail("a batch was scored without a card"))
    STATS.reset()
    out = tmp_path / "x.vcf"
    assert main(["-F", "vcf", *_golden_args(data_dir), str(out)]) == 1
    assert "no CUDA device is available" in capsys.readouterr().err
    assert STATS.snapshot().get("decode", 0) > 0
    assert [ln for ln in out.read_text().splitlines()
            if not ln.startswith("#")] == []


def test_device_is_resolved_where_first_needed(data_dir, monkeypatch):
    """The library API: a device's name is resolved by the path that
    needs it; exact windows the native layer scores never ask."""
    from somatic_sniper_tpu_torch import device, runner
    from somatic_sniper_tpu_torch.parallel import sharded

    asked = []
    real = device.resolve_device

    def spy(name):
        asked.append(name)
        return real(name)

    monkeypatch.setattr(runner, "resolve_device", spy)
    monkeypatch.setattr(sharded, "resolve_device", spy)
    d = data_dir / "e2e" / "sim1"
    args = (str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
            "vcf")
    exact = list(runner.call_pair(*args, device="cuda"))
    exact_w = list(sharded.call_pair_sharded(*args, device="cuda",
                                             window_size=700))
    assert asked == [] and exact == exact_w and len(exact) > 10
    fast = list(runner.call_pair(*args, precision="fast", device="cpu"))
    fast_w = list(sharded.call_pair_sharded(*args, precision="fast",
                                            device="cpu", window_size=700))
    assert asked == ["cpu", "cpu"] and fast == fast_w
    with pytest.raises(device.DeviceUnavailable):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        list(runner.call_pair(*args, precision="fast", device="cuda"))


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
