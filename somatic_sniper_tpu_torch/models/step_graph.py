"""The scoring steps as captured CUDA graphs, one a shape.

The JAX package jits both of its scoring steps with static shape
arguments: ``call_batch_packed`` for a slab
(somatic_sniper_tpu/models/somatic.py:388-395) and ``call_batch_stacked``
for a column batch (:475-538), whose batch axis it first pads to a few
sizes (``_b_bucket``, somatic_sniper_tpu/runner.py:737-747).  XLA builds
one executable a shape, and a slab or a batch is one dispatch of it.
The port's counterpart is a CUDA graph captured from the eager step: the
same kernels with the same arguments, replayed with one host call, so
the rows are the eager step's bytes.  A ``StepSpec`` names the step:

* the slab step, ``call_batch_packed`` over int32 raw lanes [2, B, D]
  and packed metadata [3, B] (``SLAB``);
* the batch step, ``call_batch_stacked(..., compact=True, max_emit=K,
  precision=...)`` over uint16 lanes [2, B, D] and metadata [7, B]
  (``packed16``), or int32 slot words and metadata [3, B].

A process scores on one device; several GPUs are reached through
several processes (``--shards`` / ``--jobs``, see ``runner``).  A graph reads and writes
fixed addresses.  Each key (device, B, D, ModelParams, DeviceTables,
StepSpec) owns static inputs of the spec's dtype and shape, pinned host
buffers beside them, and the ``count`` / ``rows`` / ``err`` its capture
allocated.  Every capture on a device draws on that device's one graph
pool, so a capture reuses the blocks an earlier one freed (an exact key
at (65536, 40) frees ~900 MiB of f64 terms and ranks); the keys then
share those blocks, so no two replays may overlap on the device and
each replay's outputs are copied out before the next replay starts: a
replay waits on an event of the device's last replay, whatever stream
it is queued on, and the slab step copies its rows to pinned memory,
the batch step to tensors of its own on the same stream.  The pools,
capture streams and last-replay events are held a device, as the keys
are.

When a key captures:

* a slab's at its first slab, after ``WARMUP_STEPS`` eager steps on the
  capture stream: the slab path runs a few shapes (B = 8192, a depth
  bucket each) many times over;
* a batch's at its second batch (``run_batch``): the first runs
  eagerly, the third and later replay.  A batch's B is a bucket and its
  D a depth bucket, so a run meets ten keys or so, and each depth bucket
  ends in a one-off tail; a capture costs tens of ms, more than a tail
  saves by it.  The first eager batch is the key's warm-up (it cuts the
  assembly tables of its depth and loads the kernels of its shape,
  neither of which a capture may do), so the capture runs no warm-up
  step of its own.

``ops.glfgen_kernels.LAUNCHES`` is counted by the wrappers, in Python,
and a replay runs no wrapper.  The warm-up steps and the capture are
left out of the counts; each replay adds what the capture counted.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import glfgen_kernels as K
from ..utils.stats import STATS
from .somatic import CompactResult, call_batch_packed, call_batch_stacked
from .tables import DeviceTables, ModelParams

# eager steps on the capture stream before a slab's capture: they cut
# the assembly tables, load the kernel library and fill the allocator's
# caches, none of which a capture may do
WARMUP_STEPS = 2


class StepSpec(NamedTuple):
    """Which scoring step a key captures, beside its shape: the slab
    step (``packed16`` None) or the batch step over one upload layout,
    in one precision, with at most ``max_emit`` compact rows."""

    packed16: bool | None = None
    precision: str = "fast"
    max_emit: int = 0

    @property
    def stacked_dtype(self) -> torch.dtype:
        return torch.uint16 if self.packed16 else torch.int32

    @property
    def meta_rows(self) -> int:
        return 7 if self.packed16 else 3

    def score(self, stacked, meta, dtabs: DeviceTables,
              params: ModelParams) -> CompactResult:
        """The eager step of this spec."""
        if self.packed16 is None:
            return call_batch_packed(stacked, meta, dtabs, params)
        return call_batch_stacked(stacked, meta, dtabs, params,
                                  packed16=self.packed16,
                                  max_emit=self.max_emit, compact=True,
                                  precision=self.precision)


SLAB = StepSpec()


def cuda_graph_capture(step, stream, pool):
    """Captures ``step()`` on ``stream`` into a CUDA graph that draws on
    ``pool``; returns (the captured call's outputs, the replay).  The
    capture mode is the thread's own, so the host threads that run
    beside the capturing thread may use the card.  ``torch.cuda.graph``
    would also synchronize the device, collect the interpreter's garbage
    and empty the allocator's cache first, a pause of the whole run that
    the capture does not need: the warm-up ran before it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = step()
        finally:
            graph.capture_end()
    return out, graph.replay


def _zeros(shape, dtype, device) -> torch.Tensor:
    # uint16 has few kernels on every build: zero it through int16
    carrier = torch.int16 if dtype == torch.uint16 else dtype
    return torch.zeros(shape, dtype=carrier, device=device).view(dtype)


class CapturedStep:
    """One key's captured step and its fixed buffers."""

    def __init__(self, B: int, D: int, dtabs: DeviceTables,
                 params: ModelParams, device: torch.device, spec: StepSpec,
                 capture, pool, stream, warmup_steps: int):
        pin = device.type == "cuda"
        dtype = spec.stacked_dtype
        # zeros: the warm-up steps score empty columns, whatever the
        # slab to come holds
        self.stacked = _zeros((2, B, D), dtype, device)
        self.meta = _zeros((spec.meta_rows, B), torch.int32, device)
        self._stacked_h = torch.empty((2, B, D), dtype=dtype, pin_memory=pin)
        self._meta_h = torch.empty((spec.meta_rows, B), dtype=torch.int32,
                                   pin_memory=pin)
        # the last upload out of the pinned buffers, which the next one
        # overwrites
        self._uploaded = torch.cuda.Event() if pin else None
        self.dtabs = dtabs  # held, so that the key's id() stays its own
        self.device = device

        def step():
            return spec.score(self.stacked, self.meta, dtabs, params)

        t0 = time.perf_counter()
        before = dict(K.LAUNCHES)
        caller = _current_stream(device)
        try:
            if stream is not None:
                stream.wait_stream(caller)
            with _on(stream):
                for _ in range(warmup_steps):
                    step()
            counted = dict(K.LAUNCHES)
            out, self._replay = capture(step, stream, pool)
            self.launches = {k: K.LAUNCHES[k] - counted[k]
                             for k in K.LAUNCHES if K.LAUNCHES[k] != counted[k]}
        finally:
            K.LAUNCHES.update(before)  # no replay's launches: left out
        if stream is not None:
            caller.wait_stream(stream)
        self.count, self.rows, self.err = out.count, out.rows, out.err
        self._count_h = torch.empty(self.count.shape, dtype=torch.int32,
                                    pin_memory=pin)
        self._rows_h = torch.empty(self.rows.shape, dtype=torch.int32,
                                   pin_memory=pin)
        self._err_h = torch.empty(self.err.shape, dtype=torch.int32,
                                  pin_memory=pin)
        if pin:
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def upload(self, stacked_h: np.ndarray, meta_h: np.ndarray) -> None:
        """Copies one host slab or batch (lanes of the spec's width,
        int32 metadata) into the static inputs, through the pinned
        buffers, on the current stream."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
        st = self._stacked_h.numpy()
        np.copyto(st, stacked_h.view(st.dtype))
        np.copyto(self._meta_h.numpy(), meta_h)
        self.stacked.copy_(self._stacked_h, non_blocking=True)
        self.meta.copy_(self._meta_h, non_blocking=True)
        if self._uploaded is not None:
            self._uploaded.record(_current_stream(self.device))

    def replay(self) -> None:
        """Runs the captured step on the current stream and counts its
        kernel launches."""
        self._replay()
        for k, v in self.launches.items():
            K.LAUNCHES[k] += v

    def fetch(self) -> tuple[int, np.ndarray]:
        """(count, rows[:count]) of the last replay, as numpy, after one
        wait for the current stream.  The error word comes home with
        them: set (a slab deeper than 255 whose rescaled class counts
        fell outside the assembly tables), it raises the stand-alone
        ``assembly10``'s ValueError, as ``runner.collect_pending`` does
        for a batch."""
        self._count_h.copy_(self.count, non_blocking=True)
        self._err_h.copy_(self.err, non_blocking=True)
        self._rows_h.copy_(self.rows, non_blocking=True)
        if self.device.type == "cuda":
            _current_stream(self.device).synchronize()
        from ..runner import _raise_on_count_error

        _raise_on_count_error([int(self._err_h)], [self.stacked.shape[2]])
        n = int(self._count_h)
        return n, self._rows_h[:n].numpy().copy()


def _current_stream(device: torch.device):
    return (torch.cuda.current_stream(device) if device.type == "cuda"
            else None)


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _device(device: torch.device):
    """``device`` current inside the block, where it is a card."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class SlabStepGraph:
    """The captured scoring steps of a process, slab and batch, one a
    key (device, B, D, ModelParams, DeviceTables, StepSpec).

    ``capture`` turns a step into (its outputs, a replay); on a card it
    is ``cuda_graph_capture``, and ``device_types`` are the devices it
    captures on.  Each device has its own graph pool and capture stream.
    A capture or a replay that fails raises: nothing runs the eager step
    in its place."""

    def __init__(self, capture=cuda_graph_capture,
                 device_types: tuple[str, ...] = ("cuda",)):
        self._capture = capture
        self._device_types = device_types
        self._steps: dict[tuple, CapturedStep] = {}
        self._seen: set[tuple] = set()  # batch keys that ran eagerly once
        self._lock = threading.RLock()
        self._pools: dict[torch.device, object] = {}
        self._streams: dict[torch.device, object] = {}
        self._last_replay: dict[torch.device, object] = {}

    def captures_on(self, device) -> bool:
        return torch.device(device).type in self._device_types

    @staticmethod
    def key(device, B: int, D: int, params: ModelParams,
            dtabs: DeviceTables, spec: StepSpec = SLAB) -> tuple:
        return (torch.device(device), B, D, params, id(dtabs), spec)

    def step(self, B: int, D: int, dtabs: DeviceTables, params: ModelParams,
             device, spec: StepSpec = SLAB,
             warmup_steps: int = WARMUP_STEPS) -> CapturedStep:
        """The captured step of this key, captured now if it is new, with
        the key's device current, on its capture stream, into its pool."""
        device = torch.device(device)
        key = self.key(device, B, D, params, dtabs, spec)
        with self._lock:
            step = self._steps.get(key)
            if step is None:
                pool = None
                if device.type == "cuda":
                    pool = self._pools.setdefault(
                        device, torch.cuda.graph_pool_handle())
                with _device(device):
                    step = CapturedStep(B, D, dtabs, params, device, spec,
                                        self._capture, pool,
                                        self._stream(device), warmup_steps)
                self._steps[key] = step
            return step

    def _stream(self, device: torch.device):
        """The device's capture stream: every capture into the shared
        pool runs on it."""
        if device.type != "cuda":
            return None
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _replay(self, step: CapturedStep) -> None:
        """``step.replay()`` on the current stream, queued after the
        device's last replay, whose blocks of the shared pool it may
        reuse; the caller holds the lock and copies the outputs out
        before it lets go."""
        stream = _current_stream(step.device)
        last = self._last_replay.get(step.device)
        if last is not None:
            stream.wait_event(last)
        step.replay()

    def _replayed(self, step: CapturedStep) -> None:
        """Marks the end of a replay and its copy out on the current
        stream."""
        stream = _current_stream(step.device)
        if stream is not None:
            self._last_replay[step.device] = stream.record_event()

    def run(self, stacked_h: np.ndarray, meta_h: np.ndarray,
            dtabs: DeviceTables, params: ModelParams,
            device) -> tuple[int, np.ndarray]:
        """One host slab through the captured step on the current stream:
        upload from pinned memory, replay, copy ``count`` and ``rows``
        back, one wait.  Returns ``(count, rows[:count])`` as numpy.
        The upload counts in STATS as ``device.upload``, the replay and
        the wait for its rows as ``device.score``."""
        _, B, D = stacked_h.shape
        with self._lock:
            step = self.step(B, D, dtabs, params, device)
            with STATS.timer("device.upload"):
                step.upload(stacked_h, meta_h)
            with STATS.timer("device.score"):
                self._replay(step)
                out = step.fetch()
            self._replayed(step)
            return out

    def run_batch(self, stacked_h: np.ndarray, meta_h: np.ndarray,
                  dtabs: DeviceTables, params: ModelParams, spec: StepSpec,
                  device) -> tuple[str, CompactResult]:
        """One compact batch in its host upload layout ([2, B, D] lanes,
        metadata [R, B]) through its key's step on the device's capture
        stream, after the device's last replay, without a wait.  Returns
        the route and the CompactResult on ``device``, which the current
        stream waits for.

        Route: the key's first batch is scored eagerly from a pageable
        upload ("first", the key's warm-up), its second captures without
        a warm-up step ("capture"), later ones replay from pinned
        staging ("replay"); a replay's outputs are copied to tensors of
        their own before the device's next replay.  A failed capture
        raises and keeps no graph.  The upload counts in STATS as
        ``device.upload``, the step as ``device.score``, the capture as
        ``device.capture``."""
        device = torch.device(device)
        _, B, D = stacked_h.shape
        key = self.key(device, B, D, params, dtabs, spec)
        with self._lock:
            stream = self._stream(device)
            cur = _current_stream(device)
            if stream is not None:
                # the tables were written on the current stream
                stream.wait_stream(cur)
            if key not in self._seen:
                route = "first"
                with _on(stream):
                    with STATS.timer("device.upload"):
                        up = [torch.from_numpy(np.ascontiguousarray(a))
                              .to(device) for a in (stacked_h, meta_h)]
                    with STATS.timer("device.score"):
                        out = spec.score(*up, dtabs, params)
                self._seen.add(key)
            else:
                step = self._steps.get(key)
                route = "replay" if step is not None else "capture"
                if step is None:
                    with STATS.timer("device.capture"):
                        step = self.step(B, D, dtabs, params, device, spec,
                                         0)
                with _on(stream):
                    with STATS.timer("device.upload"):
                        step.upload(stacked_h, meta_h)
                    with STATS.timer("device.score"):
                        self._replay(step)
                        out = CompactResult(*(t.clone() for t in (
                            step.count, step.rows, step.err)))
                        self._replayed(step)
            if stream is not None:
                cur.wait_stream(stream)
                for t in out:
                    t.record_stream(cur)
            return route, out

    def captures(self) -> dict[tuple, float]:
        """Seconds each key's warm-up and capture took."""
        with self._lock:
            return {k: s.capture_s for k, s in self._steps.items()}

    def pool_bytes(self, device) -> int:
        """Device bytes the device's graph pool holds (0 before its
        first capture)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        pool = self._pools.get(device)
        if pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s["device"] == device.index
                   and tuple(s["segment_pool_id"]) == tuple(pool))


# the process's captured steps: like the JAX package's jit cache, they
# live as long as the process
STEP_GRAPHS = SlabStepGraph()
