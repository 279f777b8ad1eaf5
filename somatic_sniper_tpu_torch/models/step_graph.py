"""The slab scoring step as one captured CUDA graph per shape.

The JAX package jits ``call_batch_packed`` with static shape arguments
(somatic_sniper_tpu/models/somatic.py:388-395): XLA builds one
executable per (B, D, params), and a slab is one dispatch of it
(somatic_sniper_tpu/parallel/slab.py:501).  The port's counterpart is a
CUDA graph captured from the eager step (``models.somatic
.call_batch_packed``: two ``glfgen32`` launches and the torch ops of
consensus, score, dqstats and compaction): the same kernels with the
same arguments, replayed with one host call, so the rows are the eager
step's bytes.

A graph reads and writes fixed addresses.  Each key (device, B, D,
ModelParams, DeviceTables) owns static inputs ``stacked`` [2, B, D] and
``meta`` [3, B] int32, pinned host buffers beside them, and the
``count`` / ``rows`` its capture allocated; every capture draws on one
memory pool.  So one replay runs at a time and its outputs are copied
out before the next: ``run`` holds a lock from the upload to the host
copy of the rows.

``ops.glfgen_kernels.LAUNCHES`` is counted by the wrappers, in Python,
and a replay runs no wrapper.  The warm-up steps and the capture are
left out of the counts; each replay adds what the capture counted.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..ops import glfgen_kernels as K
from .somatic import call_batch_packed
from .tables import DeviceTables, ModelParams

# eager steps on the capture stream before a capture: they cut the
# assembly tables, load the kernel library and fill the allocator's
# caches, none of which a capture may do
WARMUP_STEPS = 2


def cuda_graph_capture(step, stream, pool):
    """Captures ``step()`` on ``stream`` into a CUDA graph that draws on
    ``pool``; returns (the captured call's outputs, the replay).  The
    capture mode is the thread's own, so the host threads that run
    beside the slab thread may use the card.  ``torch.cuda.graph`` would
    also synchronize the device, collect the interpreter's garbage and
    empty the allocator's cache first, a pause of the whole run that
    the capture does not need: the warm-up ran on ``stream`` itself."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = step()
        finally:
            graph.capture_end()
    return out, graph.replay


class CapturedStep:
    """One key's captured step and its fixed buffers."""

    def __init__(self, B: int, D: int, dtabs: DeviceTables,
                 params: ModelParams, device: torch.device,
                 capture, pool, stream):
        pin = device.type == "cuda"
        # zeros: the warm-up steps score empty columns, whatever the
        # slab to come holds
        self.stacked = torch.zeros((2, B, D), dtype=torch.int32,
                                   device=device)
        self.meta = torch.zeros((3, B), dtype=torch.int32, device=device)
        self._stacked_h = torch.empty((2, B, D), dtype=torch.int32,
                                      pin_memory=pin)
        self._meta_h = torch.empty((3, B), dtype=torch.int32, pin_memory=pin)
        self.dtabs = dtabs  # held, so that the key's id() stays its own
        self.device = device

        def step():
            return call_batch_packed(self.stacked, self.meta, dtabs, params)

        t0 = time.perf_counter()
        before = dict(K.LAUNCHES)
        caller = _current_stream(device)
        try:
            if stream is not None:
                stream.wait_stream(caller)
            with _on(stream):
                for _ in range(WARMUP_STEPS):
                    step()
            counted = dict(K.LAUNCHES)
            out, self._replay = capture(step, stream, pool)
            self.launches = {k: K.LAUNCHES[k] - counted[k]
                             for k in K.LAUNCHES if K.LAUNCHES[k] != counted[k]}
        finally:
            K.LAUNCHES.update(before)  # no replay's launches: left out
        if stream is not None:
            caller.wait_stream(stream)
        self.count, self.rows = out.count, out.rows
        self._count_h = torch.empty(self.count.shape, dtype=torch.int32,
                                    pin_memory=pin)
        self._rows_h = torch.empty(self.rows.shape, dtype=torch.int32,
                                   pin_memory=pin)
        if pin:
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def upload(self, stacked_h: np.ndarray, meta_h: np.ndarray) -> None:
        """Copies one host slab (uint32 lanes, int32 metadata) into the
        static inputs, through the pinned buffers, on the current
        stream."""
        np.copyto(self._stacked_h.numpy(), stacked_h.view(np.int32))
        np.copyto(self._meta_h.numpy(), meta_h)
        self.stacked.copy_(self._stacked_h, non_blocking=True)
        self.meta.copy_(self._meta_h, non_blocking=True)

    def replay(self) -> None:
        """Runs the captured step on the current stream and counts its
        kernel launches."""
        self._replay()
        for k, v in self.launches.items():
            K.LAUNCHES[k] += v

    def fetch(self) -> tuple[int, np.ndarray]:
        """(count, rows[:count]) of the last replay, as numpy, after one
        wait for the current stream."""
        self._count_h.copy_(self.count, non_blocking=True)
        self._rows_h.copy_(self.rows, non_blocking=True)
        if self.device.type == "cuda":
            _current_stream(self.device).synchronize()
        n = int(self._count_h)
        return n, self._rows_h[:n].numpy().copy()


def _current_stream(device: torch.device):
    return (torch.cuda.current_stream(device) if device.type == "cuda"
            else None)


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class SlabStepGraph:
    """The captured slab steps of a process, one a key (device, B, D,
    ModelParams, DeviceTables), made at a key's first slab.

    ``capture`` turns a step into (its outputs, a replay); on a card it
    is ``cuda_graph_capture``.  A capture or a replay that fails raises:
    nothing runs the eager step in its place."""

    def __init__(self, capture=cuda_graph_capture):
        self._capture = capture
        self._steps: dict[tuple, CapturedStep] = {}
        self._lock = threading.RLock()
        self._pool = None
        self._streams: dict[torch.device, object] = {}

    @staticmethod
    def key(device, B: int, D: int, params: ModelParams,
            dtabs: DeviceTables) -> tuple:
        return (torch.device(device), B, D, params, id(dtabs))

    def step(self, B: int, D: int, dtabs: DeviceTables, params: ModelParams,
             device) -> CapturedStep:
        """The captured step of this key, captured now if it is new."""
        device = torch.device(device)
        key = self.key(device, B, D, params, dtabs)
        with self._lock:
            step = self._steps.get(key)
            if step is None:
                if device.type == "cuda" and self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                step = CapturedStep(B, D, dtabs, params, device,
                                    self._capture, self._pool,
                                    self._stream(device))
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

    def run(self, stacked_h: np.ndarray, meta_h: np.ndarray,
            dtabs: DeviceTables, params: ModelParams,
            device) -> tuple[int, np.ndarray]:
        """One host slab through the captured step on the current stream:
        upload from pinned memory, replay, copy ``count`` and ``rows``
        back, one wait.  Returns ``(count, rows[:count])`` as numpy."""
        _, B, D = stacked_h.shape
        with self._lock:
            step = self.step(B, D, dtabs, params, device)
            step.upload(stacked_h, meta_h)
            step.replay()
            return step.fetch()

    def captures(self) -> dict[tuple, float]:
        """Seconds each key's warm-up and capture took."""
        with self._lock:
            return {k: s.capture_s for k, s in self._steps.items()}

    def pool_bytes(self, device) -> int:
        """Device bytes the shared pool holds (0 before a capture)."""
        if self._pool is None:
            return 0
        index = torch.cuda._get_device_index(device, optional=True)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s["device"] == index
                   and tuple(s["segment_pool_id"]) == tuple(self._pool))


# the process's captured steps: like the JAX package's jit cache, they
# live as long as the process
STEP_GRAPHS = SlabStepGraph()
