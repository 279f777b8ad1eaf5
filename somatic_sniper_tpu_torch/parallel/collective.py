"""Cross-process record merge over ``torch.distributed``.

Port of somatic_sniper_tpu/parallel/collective.py.  The file-based merge
(scripts.merge_shards) assumes the per-shard outputs land on a
filesystem the merging host can read; this path ships the shard records
between the processes instead, and process 0 writes the merged output.

The protocol is the source's.  Memory is bounded: shards stream through
fixed-size chunks.  One all-gather of ``(size, chunk)`` agrees on the
smallest chunk any process asked for and, from the largest shard, on the
number of rounds, so every process runs the same collective sequence;
each round all-gathers the valid lengths and one ``[chunk]`` uint8
tensor per process, and process 0 spools each shard's bytes to a
temporary file before the in-order concatenation.  Peak memory is
O(chunk x processes) (default chunk 4 MiB), whatever the shards' sizes.

Why the gloo backend and host tensors, where the source gathers over
the accelerator fabric: the shard bytes are files on the host, so a
device collective would only add two copies; NCCL refuses two ranks on
one GPU, which is how several processes share a one-card machine; and
``monitored_barrier``, the rendezvous with a timeout that turns a dead
peer into an error instead of a hang, exists for gloo only.  That
barrier is public API, so the source's guard against a private one
going away has no counterpart.
"""

from __future__ import annotations

import os
import tempfile
from datetime import timedelta

import torch

from ..scripts.merge_shards import merge

DEFAULT_CHUNK = 4 << 20
DEFAULT_TIMEOUT_MS = 600000


def merge_timeout_ms() -> int:
    """``SNIPER_MERGE_TIMEOUT_MS`` (default 600000)."""
    try:
        return int(os.environ.get("SNIPER_MERGE_TIMEOUT_MS",
                                  str(DEFAULT_TIMEOUT_MS)))
    except ValueError:
        return DEFAULT_TIMEOUT_MS


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def merge_barrier(timeout_ms: int | None = None) -> None:
    """Pre-merge rendezvous with a timeout (failure detection).

    An all-gather waits for every process: if a peer died mid-run the
    survivors would sit in it until the group's own timeout.  This
    barrier runs first and raises (RuntimeError) when a process is
    missing after ``timeout_ms`` (``SNIPER_MERGE_TIMEOUT_MS``), so
    survivors exit cleanly with their shard outputs and manifests
    intact.  A no-op when no process group is up."""
    if timeout_ms is None:
        timeout_ms = merge_timeout_ms()
    if not _group_up():  # single process: nothing to wait for
        return
    import torch.distributed as dist

    dist.monitored_barrier(timeout=timedelta(milliseconds=timeout_ms))


def _chunk_bytes() -> int:
    try:
        return max(4096, int(os.environ.get("SNIPER_MERGE_CHUNK",
                                            DEFAULT_CHUNK)))
    except ValueError:
        return DEFAULT_CHUNK


def _all_gather(t: torch.Tensor, num_processes: int) -> torch.Tensor:
    """``[num_processes, *t.shape]``: every process's ``t`` (a host
    tensor), in rank order."""
    if not _group_up():
        if num_processes != 1:
            raise RuntimeError(
                f"collective merge of {num_processes} processes without a "
                "process group (SNIPER_COORDINATOR unset?)")
        return t[None]
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(num_processes)]
    dist.all_gather(out, t)
    return torch.stack(out)


def collective_merge(
    out_path: str, shard_path: str, process_id: int, num_processes: int,
    chunk: int | None = None,
) -> None:
    """All-gather every process's shard records in bounded chunks;
    process 0 writes the merged output.  Must be called by ALL
    processes (it is a collective); non-zero processes return after
    contributing."""
    chunk = chunk or _chunk_bytes()
    size = os.path.getsize(shard_path)
    # gather (size, my_chunk) together and agree on min(chunk): a
    # SNIPER_MERGE_CHUNK that differs between hosts would otherwise make
    # processes run mismatched collective sequences (other buffer
    # shapes, other round counts) and hang or fail mid-merge
    sz = _all_gather(torch.tensor([size, chunk], dtype=torch.int64),
                     num_processes)
    chunk = int(sz[:, 1].min())
    rounds = max(1, -(-int(sz[:, 0].max()) // chunk))

    spool_dir = None
    spools = []
    if process_id == 0:
        spool_dir = tempfile.mkdtemp(prefix="sniper_merge_")
        spools = [
            open(os.path.join(spool_dir, f"shard{i}"), "wb")
            for i in range(num_processes)
        ]
    try:
        with open(shard_path, "rb") as fh:
            for _ in range(rounds):
                data = fh.read(chunk)
                buf = torch.zeros(chunk, dtype=torch.uint8)
                if data:
                    buf[: len(data)] = torch.frombuffer(
                        bytearray(data), dtype=torch.uint8)
                lens = _all_gather(
                    torch.tensor([len(data)], dtype=torch.int64),
                    num_processes).reshape(-1)
                blobs = _all_gather(buf, num_processes)
                if process_id == 0:
                    for i in range(num_processes):
                        n = int(lens[i])
                        if n:
                            spools[i].write(blobs[i, :n].numpy().tobytes())
        if process_id == 0:
            for s in spools:
                s.close()
            merge(out_path, [s.name for s in spools])
    finally:
        if process_id == 0:
            for s in spools:
                try:
                    s.close()
                    os.unlink(s.name)
                except OSError:
                    pass
            if spool_dir:
                try:
                    os.rmdir(spool_dir)
                except OSError:
                    pass
