"""``--jobs N`` of the port's CLI: N shard worker processes and a merge.

The merged bytes must equal a single-process run, in fast and exact
precision; the clamp, the refusals and a failing worker's code follow
the JAX CLI (tests/test_failure_paths.py:53-73); workers get
``SNIPER_LOAD_POOL=1`` when they would oversubscribe the host, and the
windowed path honours that variable (tests/test_sharded.py:50).
"""

import os
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_port_util import filtered_lines  # noqa: E402

import somatic_sniper_tpu_torch.cli.main as M  # noqa: E402
from somatic_sniper_tpu_torch.parallel import sharded  # noqa: E402

CPU = torch.device("cpu")


def _sim1(data_dir, fmt="vcf"):
    d = data_dir / "e2e" / "sim1"
    return d, ["-F", fmt, "-f", str(d / "ref.fa"), str(d / "tumor.bam"),
               str(d / "normal.bam")]


@pytest.mark.parametrize("precision,fmt", [
    ("fast", "vcf"), ("exact", "vcf"), ("fast", "classic"), ("exact", "bed"),
])
def test_jobs_2_equals_single_process(data_dir, tmp_path, precision, fmt):
    d, args = _sim1(data_dir, fmt)
    common = ["--device", "cpu", "--precision", precision, *args]
    single, merged = tmp_path / "single", tmp_path / "merged"
    # one process on the same windowed path
    assert M.main(["--shard-index", "0", *common, str(single)]) == 0
    assert M.main(["--jobs", "2", *common, str(merged)]) == 0
    assert filtered_lines(merged) == filtered_lines(single)
    assert len(filtered_lines(merged)) > 10
    if precision == "exact" and fmt == "vcf":
        assert filtered_lines(merged) == filtered_lines(d / "expected.vcf")
    # the workers' files are gone
    assert not list(tmp_path.glob("*shard*"))


@pytest.mark.parametrize("extra", [["--manifest", "m"],
                                   ["--shard-index", "0"]],
                         ids=["manifest", "shard-index"])
def test_jobs_rejects_manifest_and_shard_index(capsys, data_dir, tmp_path,
                                               extra):
    _, args = _sim1(data_dir)
    out = tmp_path / "x.out"
    assert M.main(["--device", "cpu", "--jobs", "2", *extra, *args,
                   str(out)]) == 1
    assert "cannot combine" in capsys.readouterr().err
    assert not out.exists()


def test_jobs_clamp_and_worker_failure(capfd, data_dir, tmp_path):
    """--jobs above the core count clamps with a warning, and a failing
    worker (bad reference) propagates its nonzero exit with a message;
    nothing is merged."""
    d = data_dir / "e2e" / "sim1"
    out = tmp_path / "x.out"
    rc = M.main(["--device", "cpu", "-f", str(tmp_path / "missing.fa"),
                 "--jobs", "99", str(d / "tumor.bam"), str(d / "normal.bam"),
                 str(out)])
    err = capfd.readouterr().err
    assert rc == 1
    assert f"clamped to {os.cpu_count()}" in err
    assert "worker failed (exit 1)" in err
    assert not out.exists()


def test_jobs_without_a_card_exits_1(capfd, data_dir, tmp_path, monkeypatch):
    """The parent resolves no device (it does not even import torch): it
    builds, spawns, and learns of the missing card from its workers, each
    of which exits 1 with the device's message."""
    from somatic_sniper_tpu_torch.ops import build

    monkeypatch.setattr(build, "build", lambda: None)  # as if built
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    _, args = _sim1(data_dir)
    out = tmp_path / "x.out"
    assert M.main(["--jobs", "2", "--precision", "fast", *args,
                   str(out)]) == 1
    err = capfd.readouterr().err
    assert err.count("no CUDA device") == 2
    assert "worker failed (exit 1)" in err
    assert not out.exists()


def test_jobs_parent_without_nvcc_exits_1(capsys, data_dir, tmp_path,
                                          monkeypatch):
    """--device cuda in fast precision makes the parent build the
    kernels before it spawns; where there is no compiler it says so and
    exits 1."""
    from somatic_sniper_tpu_torch.ops import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    _, args = _sim1(data_dir)
    out = tmp_path / "x.out"
    assert M.main(["--jobs", "2", "--precision", "fast", *args,
                   str(out)]) == 1
    assert "nvcc not found" in capsys.readouterr().err
    assert not out.exists()


class _FakePopen:
    """Records what --jobs would start, writes the worker's output."""

    started: list = []

    def __init__(self, cmd, env=None):
        type(self).started.append((cmd, env))
        with open(cmd[-1], "w") as fh:
            fh.write("##header\n" if cmd[cmd.index("--shard-index") + 1]
                     == "0" else "##header\nrecord\n")

    def wait(self):
        return 0


@pytest.mark.parametrize("ncpu,user_pool,want_pool", [
    (2, None, "1"), (3, None, "1"), (4, None, None), (64, None, None),
    (2, "3", "3"),
], ids=["2-cores", "3-cores", "4-cores", "64-cores", "user-set"])
def test_jobs_worker_command_and_thread_budget(monkeypatch, data_dir,
                                               tmp_path, ncpu, user_pool,
                                               want_pool):
    """Workers get SNIPER_LOAD_POOL=1 when 2 * jobs > cores, unless the
    user set it; every model flag, and --device, is passed on."""
    _, args = _sim1(data_dir)
    monkeypatch.setattr(os, "cpu_count", lambda: ncpu)
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    monkeypatch.setattr(_FakePopen, "started", [])
    if user_pool is None:
        monkeypatch.delenv("SNIPER_LOAD_POOL", raising=False)
    else:
        monkeypatch.setenv("SNIPER_LOAD_POOL", user_pool)
    out = tmp_path / "merged"
    assert M.main(["--device", "cpu", "--jobs", "2", "--precision", "fast",
                   "-q", "3", "-Q", "20", "-L", "-G", "-p", "-J", "-s",
                   "0.002", "-T", "0.8", "-N", "3", "-r", "0.003", "-n", "NN",
                   "-t", "TT", "--window-size", "777", *args, str(out)]) == 0
    assert out.read_text() == "##header\nrecord\n"
    assert len(_FakePopen.started) == 2
    for i, (cmd, env) in enumerate(_FakePopen.started):
        assert cmd[1:3] == ["-m", "somatic_sniper_tpu_torch.cli.main"]
        parsed = vars(M.build_parser().parse_args(cmd[3:]))
        assert (parsed["shards"], parsed["shard_index"]) == (2, i)
        assert parsed["device"] == "cpu" and parsed["jobs"] == 1
        assert parsed["precision"] == "fast" and parsed["format"] == "vcf"
        assert (parsed["mapq"], parsed["min_somatic_qual"]) == (3, 20)
        assert parsed["no_loh"] and parsed["no_gor"] and parsed["no_priors"]
        assert parsed["joint"] and parsed["somatic_rate"] == 0.002
        assert (parsed["theta"], parsed["n_hap"], parsed["het_rate"]) \
            == (0.8, 3, 0.003)
        assert (parsed["normal_id"], parsed["tumor_id"]) == ("NN", "TT")
        assert parsed["window_size"] == 777
        assert env.get("SNIPER_LOAD_POOL") == want_pool
        assert float(env[M.SPAWNED_AT_ENV]) > 0


def test_load_pool_env_is_honoured(monkeypatch, data_dir):
    """SNIPER_LOAD_POOL sizes the region-load pool, and the pool's width
    never changes the output."""
    d = data_dir / "e2e" / "sim1"
    widths = []
    real = sharded.ThreadPoolExecutor

    def spy(max_workers=None, **kw):
        widths.append(max_workers)
        return real(max_workers=max_workers, **kw)

    monkeypatch.setattr(sharded, "ThreadPoolExecutor", spy)

    def lines():
        return list(sharded.call_pair_sharded(
            str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
            "vcf", precision="fast", window_size=700, device=CPU))

    monkeypatch.setenv("SNIPER_LOAD_POOL", "1")
    one = lines()
    monkeypatch.setenv("SNIPER_LOAD_POOL", "5")
    five = lines()
    monkeypatch.setenv("SNIPER_LOAD_POOL", "garbage")
    default = lines()
    assert widths == [1, 5, max(2, min(6, (os.cpu_count() or 2) - 2))]
    assert one == five == default and len(one) > 10


def test_worker_reports_startup_and_launches(monkeypatch, capsys, data_dir,
                                             tmp_path):
    """A --jobs worker (it finds its spawn time in the environment)
    adds its start-up to the stage summary; the summary also lists the
    kernels launched, none on the CPU."""
    import time

    _, args = _sim1(data_dir)
    monkeypatch.setenv(M.SPAWNED_AT_ENV, repr(time.time() - 5.0))
    assert M.main(["--device", "cpu", "--precision", "fast", "--stats",
                   "--shards", "2", "--shard-index", "1", *args,
                   str(tmp_path / "w.out")]) == 0
    err = capsys.readouterr().err
    stages = {ln.split()[0]: float(ln.split()[1][:-1])
              for ln in err.splitlines() if "worker_startup" in ln}
    assert set(stages) == {"worker_startup", "worker_startup.imports"}
    assert 5.0 <= stages["worker_startup.imports"] \
        <= stages["worker_startup"] < 60.0
    assert "launches_" not in err
