"""``--merge collective`` and the distributed init of the port's CLI, on
``torch.distributed`` with the gloo backend, all on the CPU.

Two (or three) real worker processes join through ``SNIPER_COORDINATOR``;
each defaults to its genome shard, and the merged bytes must equal the
single-process golden (tests/test_distributed.py:80, :97).  The failure
semantics of ``_run_collective`` are driven in-process
(tests/test_failure_paths.py:150-235), and a worker killed mid-run must
fail the survivors fast, after which a re-run with the manifests
resumes.
"""

import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_port_util import filtered_lines  # noqa: E402

import somatic_sniper_tpu_torch.cli.main as M  # noqa: E402
from somatic_sniper_tpu_torch.parallel import collective  # noqa: E402
from somatic_sniper_tpu_torch.scripts.merge_shards import merge  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _records(path) -> int:
    return sum(1 for ln in filtered_lines(path) if not ln.startswith("#"))


def _spawn(d, outs, extra_args=(), env_of=None, timeout=120):
    """One worker process a path in ``outs``, joined through a free
    local port; returns (exit codes, stderr texts).  Every process is
    killed when the time limit passes."""
    n = len(outs)
    port = _free_port()
    procs = []
    for i in range(n):
        env = dict(os.environ, SNIPER_COORDINATOR=f"127.0.0.1:{port}",
                   SNIPER_NUM_PROCESSES=str(n), SNIPER_PROCESS_ID=str(i),
                   OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        env.update(env_of(i) if env_of else {})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "somatic_sniper_tpu_torch.cli.main",
             "--device", "cpu", "-F", "vcf", "--precision", "fast",
             *extra_args(i), "-f", str(d / "ref.fa"), str(d / "tumor.bam"),
             str(d / "normal.bam"), str(outs[i])],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    rcs, errs = [], []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            rcs.append(p.returncode)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, errs


def test_two_process_distributed_matches_golden(data_dir, tmp_path):
    """--merge files (the default): each process writes its own shard,
    and the port's merge_shards gives the golden bytes."""
    d = data_dir / "e2e" / "sim1"
    outs = [tmp_path / f"shard{i}.vcf" for i in range(2)]
    rcs, errs = _spawn(d, outs, extra_args=lambda i: ())
    assert rcs == [0, 0], "\n---\n".join(errs)
    merged = tmp_path / "merged.vcf"
    merge(str(merged), [str(o) for o in outs])
    assert filtered_lines(merged) == filtered_lines(d / "expected.vcf")
    n0, n1 = _records(outs[0]), _records(outs[1])
    assert n0 + n1 == _records(merged) and n0 > 0 and n1 > 0


@pytest.mark.parametrize("chunk", [None, "4096"], ids=["default", "4096"])
def test_two_process_collective_merge(data_dir, tmp_path, chunk):
    """--merge collective: the shard bytes ride all-gathers and process
    0 writes the merged output; also in several rounds of 4096 bytes
    (one process asks for a larger chunk: the smallest is agreed)."""
    d = data_dir / "e2e" / "sim1"
    out = tmp_path / "merged.vcf"

    def env_of(i):
        return {} if chunk is None else {
            "SNIPER_MERGE_CHUNK": chunk if i == 0 else "65536"}

    rcs, errs = _spawn(d, [out, out],
                       extra_args=lambda i: ("--merge", "collective"),
                       env_of=env_of)
    assert rcs == [0, 0], "\n---\n".join(errs)
    assert filtered_lines(out) == filtered_lines(d / "expected.vcf")
    shards = [tmp_path / f"merged.vcf.shard{i}" for i in range(2)]
    n0, n1 = _records(shards[0]), _records(shards[1])
    assert n0 + n1 == _records(out) and n0 > 0 and n1 > 0
    assert max(s.stat().st_size for s in shards) > 4096


def test_worker_death_fails_fast_then_resumes(data_dir, tmp_path):
    """One of three workers dies hard after its first window: the
    survivors finish their shards and must exit 3 at the merge barrier
    within its short timeout, every shard output and manifest kept; a
    re-run with the same manifests skips what is done and the merge
    equals the golden."""
    d = data_dir / "e2e" / "sim1"
    out = tmp_path / "merged.vcf"
    manifests = [tmp_path / f"m{i}.jsonl" for i in range(3)]

    def args(i):  # 500 bp windows: every shard has four
        return ("--merge", "collective", "--window-size", "500",
                "--manifest", str(manifests[i]))

    t0 = time.monotonic()
    rcs, errs = _spawn(d, [out] * 3, extra_args=args, env_of=lambda i: {
        "SNIPER_MERGE_TIMEOUT_MS": "4000",
        **({"SNIPER_FAULT_EXIT_AFTER_WINDOW": "1"} if i == 1 else {})})
    assert rcs == [3, 17, 3], "\n---\n".join(errs)
    assert time.monotonic() - t0 < 60
    for i in (0, 2):
        assert "merge barrier failed" in errs[i], errs[i]
        assert "re-run with the same manifests" in errs[i]
    assert not out.exists()
    for i, m in enumerate(manifests):
        assert m.stat().st_size > 0
        assert (tmp_path / f"merged.vcf.shard{i}").exists()
    assert len(manifests[1].read_text().splitlines()) == 1

    rcs, errs = _spawn(d, [out] * 3, extra_args=args, env_of=lambda i: {
        "SNIPER_MERGE_TIMEOUT_MS": "120000"})
    assert rcs == [0, 0, 0], "\n---\n".join(errs)
    assert filtered_lines(out) == filtered_lines(d / "expected.vcf")


def test_collective_merge_chunking_single_process(tmp_path, monkeypatch):
    """The chunk loop itself (no process group): a shard far larger
    than the chunk streams through many rounds and comes out whole."""
    shard = tmp_path / "shard0"
    payload = b"#header\n" + b"".join(
        f"17\t{i}\trecord line {i}\n".encode() for i in range(20000))
    shard.write_bytes(payload)
    out = tmp_path / "out"
    collective.collective_merge(str(out), str(shard), 0, 1, chunk=4096)
    assert out.read_bytes() == payload
    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "4096")
    out2 = tmp_path / "out2"
    collective.collective_merge(str(out2), str(shard), 0, 1)
    assert out2.read_bytes() == payload
    with pytest.raises(RuntimeError, match="without a process group"):
        collective.collective_merge(str(out), str(shard), 0, 2)


def test_run_collective_failure_semantics(monkeypatch, capsys, tmp_path):
    """Every branch of the collective worker wrapper: input errors hard-
    exit 1, runtime/barrier/merge failures hard-exit 3 (shard output
    kept for a manifest resume), the happy path merges and returns
    soft."""
    args = types.SimpleNamespace(output=str(tmp_path / "out.vcf"))

    def thrower(exc):
        def fn(*a, **k):
            if exc:
                raise exc
            return 0
        return fn

    def run_with(run_exc=None, barrier_exc=None, merge_exc=None):
        monkeypatch.setattr(M, "_run", thrower(run_exc))
        monkeypatch.setattr(collective, "merge_barrier", thrower(barrier_exc))
        monkeypatch.setattr(collective, "collective_merge",
                            thrower(merge_exc))
        args.output = str(tmp_path / "out.vcf")
        return M._run_collective(args, None, None, None, None, 2, 0)

    assert run_with(run_exc=ValueError("bad input")) == (1, True)
    assert "bam-somaticsniper-torch: bad input" in capsys.readouterr().err
    assert run_with(run_exc=M.NativeUnavailable("no library")) == (1, True)
    assert "no library" in capsys.readouterr().err
    assert run_with(run_exc=RuntimeError("peer died")) == (3, True)
    assert "distributed run failed" in capsys.readouterr().err
    assert run_with(barrier_exc=RuntimeError("barrier timeout")) == (3, True)
    assert "merge barrier failed" in capsys.readouterr().err
    assert run_with(merge_exc=RuntimeError("gather died")) == (3, True)
    assert "collective merge failed" in capsys.readouterr().err
    assert run_with() == (0, False)
    assert args.output.endswith(".shard0")


def test_merge_barrier_single_process_noop(monkeypatch):
    collective.merge_barrier()  # no process group: returns at once
    monkeypatch.setenv("SNIPER_MERGE_TIMEOUT_MS", "not-a-number")
    assert collective.merge_timeout_ms() == 600000
    collective.merge_barrier()
    monkeypatch.setenv("SNIPER_MERGE_TIMEOUT_MS", "1500")
    assert collective.merge_timeout_ms() == 1500


def test_chunk_bytes_env_parsing(monkeypatch):
    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "garbage")
    assert collective._chunk_bytes() == collective.DEFAULT_CHUNK
    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "10")
    assert collective._chunk_bytes() == 4096  # floor
    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "65536")
    assert collective._chunk_bytes() == 65536


def test_distributed_init_failure_exits_3(monkeypatch, capsys, data_dir,
                                          tmp_path):
    """A coordinator nobody answers at: exit 3, nothing written."""
    monkeypatch.setenv("SNIPER_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SNIPER_NUM_PROCESSES", "two")
    monkeypatch.setenv("SNIPER_PROCESS_ID", "0")
    d = data_dir / "e2e" / "sim1"
    out = tmp_path / "x.vcf"
    assert M.main(["--device", "cpu", "-f", str(d / "ref.fa"),
                   str(d / "tumor.bam"), str(d / "normal.bam"),
                   str(out)]) == 3
    assert "distributed init failed" in capsys.readouterr().err
    assert not out.exists()
