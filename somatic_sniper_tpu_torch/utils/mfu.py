"""Microbenchmark of the scoring step, with a FLOP, byte and launch model.

Port of somatic_sniper_tpu/utils/mfu.py.  The step timed is the
production scoring step of one slab, ``models.somatic
.call_batch_packed`` over a ``[2, B, D]`` stack of raw kept-only u32
lanes with ``max_emit = B``: on a card two ``glfgen32`` launches (tumor,
normal) and the torch ops of ``models/consensus.py`` and
``models/somatic.py`` behind them, replayed as one captured CUDA graph
(``models.step_graph``), as the slab path runs it.

* ``cols_per_sec``: ``lo`` and ``hi`` back-to-back steps are timed
  (CUDA events on a card, ``time.perf_counter`` on the CPU), each after
  a warm call and as the minimum of two repeats; the rate is
  ``B * (hi - lo) / (t_hi - t_lo)``, so whatever a run costs once
  cancels.  Each step scores ``stacked ^ (previous count & 1)``,
  computed on the device with no host round trip, so successive steps
  score different lanes (on a card the flip is made in place on the
  graph's static input before each replay).  The eager step is timed
  the same way on the same inputs (``eager_slab_s``), and so is the
  whole production call of a slab, upload and fetch included
  (``graph_run_s``).  The source chains its steps in a
  ``lax.fori_loop`` with that carry to keep XLA from hoisting the body
  out of the loop; torch hoists nothing, so the carry only varies the
  inputs.
* ``flops_per_pair_column(D)`` is the source's count, unchanged.  It
  counts one-hot matrix contractions that the port does not perform
  (its kernels gather from the tables), and is kept only so that the two
  packages can be put on one like-for-like line.
* ``port_flops_per_pair_column(D)`` is the port's own count: 3 f32
  operations a lane for the rank-weighted class sums, 220 a column a
  sample for the ten-genotype assembly, and the source's 800 a pair for
  consensus and score.  ``tflops``, ``est_mfu`` and ``bound_compute_s``
  use this one.
* ``hbm_bytes_per_pair_column(D)``: what the step must move in the
  port's encoding.
* ``launches_per_step``: the device operations one step queues (torch
  ops that compute, views and bare allocations left out, each at least
  one kernel launch on a card, plus the hand-written kernels' own
  launches), counted over the eager step; a replay runs the same.
  Times the launch floor measured in the same call (the device time of
  an empty kernel replayed from a graph of 200 of them, as a step's
  kernels are) it is the third bound.  ``stream_launch_floor_s`` is the
  eager step's floor: the same kernel queued on a stream back to back
  behind a spin kernel, so that the host's own pace stays out of it.
* ``host_queue_s``: the time the host takes to queue one step's
  operations, without waiting for the device (``eager_host_queue_s``
  for the eager step).  Where it is about the measured step time the
  device is waiting for the host, and the verdict says so.

Peaks are the H100 SXM data sheet's: 67 TFLOP/s f32 (no tensor cores:
the step has no matrix product) and 3.35 TB/s HBM3.  On a card the
verdict names the bound the measured step time is closest to; a CPU run
says that it is one.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np

from ..models.fields import COMPACT_FIELDS

H100_PEAK_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# i32 words of one compact row: the slab index, the fields, and 18
# dqstats words a sample (models.somatic.CompactResult)
ROW_WORDS = 1 + len(COMPACT_FIELDS) + 36


def flops_per_pair_column(D: int) -> float:
    """The JAX package's analytic count for its ``call_batch_packed`` at
    depth D (mfu.py:60-71 there): pairwise-rotation rank, one-hot
    contractions against ``coef`` and ``lhet``, consensus and score.
    Not what the port executes; see the module docstring."""
    NK = min(D, 255) + 1
    acc = 2.0 * D * D + 32.0 * D
    assembly = (
        2.0 * 60 * NK * NK
        + 10.0 * (2 * 60 * NK + 2 * NK)
        + 6.0 * (2 * NK * NK + 2 * NK)
        + 300.0
    )
    score = 800.0
    return 2.0 * (acc + assembly) + score


def port_flops_per_pair_column(D: int) -> float:
    """f32 operations the port does for one tumor/normal column pair at
    slab depth D: a sample's rank is 3 a lane (weight gather, multiply,
    add into the class sum; the sort is integer work), its assembly 220
    a column; consensus and score 800 a pair.  Linear in D."""
    return 2.0 * (3.0 * D + 220.0) + 800.0


def hbm_bytes_per_pair_column(D: int) -> float:
    """Bytes one column pair must move: two samples of D u32 lanes and
    12 bytes of packed metadata in, one i32 compact row out."""
    return 2.0 * 4 * D + 12.0 + 4.0 * ROW_WORDS


class KernelBench(NamedTuple):
    cols_per_sec: float
    flops_per_col: float          # the source's count
    tflops: float                 # by the port's count
    est_mfu: float                # tflops over the f32 peak
    bound_compute_s: float        # a step at the f32 peak, port's count
    bound_hbm_s: float            # a step at the HBM rate
    measured_slab_s: float
    verdict: str
    B: int
    D: int
    port_flops_per_col: float
    launches_per_step: int        # device operations a step queues
    kernel_launches: dict         # hand-written kernels launched a step
    launch_floor_s: float         # an empty launch replayed from a graph,
                                  # as the step's are; 0.0 on the CPU
    bound_launch_s: float         # launches_per_step * launch_floor_s
    host_queue_s: float           # the host queueing one step, no wait
    steps_run: int                # steps this call ran, warm-up included
    eager_slab_s: float           # the eager step, on the same inputs
    eager_host_queue_s: float     # the host queueing one eager step
    stream_launch_floor_s: float  # an empty launch queued on a stream, as
                                  # the eager step's are; 0.0 on the CPU
    graph_run_s: float            # host clock of one STEP_GRAPHS.run: upload,
                                  # replay, fetch, one wait; 0.0 on the CPU


def bench_inputs(B: int, D: int) -> tuple[np.ndarray, np.ndarray]:
    """(stacked uint32 [2, B, D], meta int32 [3, B]) as the source builds
    them (mfu.py:113-137): raw kept-only lanes ``mapq | baseq<<8 |
    base16<<16 | strand<<20`` from ``default_rng(7)``, depths in
    [D/2, D], the normal's lanes the tumor's with the low baseQ bit
    flipped, ``meta[0] = ref16 << 24`` and every byte of ``meta[2]`` the
    depth."""
    rng = np.random.default_rng(7)
    depths = rng.integers(max(1, D // 2), D + 1, B).astype(np.int32)
    mapq = rng.integers(1, 61, (B, D)).astype(np.uint32)
    baseq = rng.integers(1, 41, (B, D)).astype(np.uint32)
    base16 = np.asarray([1, 2, 4, 8], np.uint32)[rng.integers(0, 4, (B, D))]
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    slots = mapq | (baseq << 8) | (base16 << 16) | (strand << 20)
    mask = np.arange(D)[None, :] < depths[:, None]
    stacked = np.where(mask[None], np.stack([slots, slots ^ 0x100]), 0)
    ref16 = rng.choice([1, 2, 4, 8], size=B).astype(np.int32)
    meta = np.zeros((3, B), np.int32)
    meta[0] = ref16 << 24
    d = depths.astype(np.uint32)
    meta.view(np.uint32)[2] = d | (d << 8) | (d << 16) | (d << 24)
    return stacked.astype(np.uint32), meta


def count_step_ops(step) -> int:
    """Run ``step()`` once and count the torch ops it dispatches that
    compute on the device: views (an output that aliases an input
    without writing it) and bare allocations launch nothing and are left
    out, as are the reads of a scalar."""
    from torch.utils._python_dispatch import TorchDispatchMode

    skip = ("empty", "empty_like", "empty_strided", "new_empty",
            "_local_scalar_dense", "lift_fresh", "detach", "alias")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if not view and func._schema.name.split("::")[1] not in skip:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        step()
    return Count.n


def _verdict(slab_s: float, bounds: dict[str, float],
             host_queue_s: float = 0.0) -> str:
    """Name the bound the measured step time is closest to, and say
    whether the host's queueing of the operations accounts for the rest."""
    live = {k: v for k, v in bounds.items() if v > 0}
    name = min(live, key=lambda k: abs(math.log(slab_s / live[k])))
    others = ", ".join(f"{k} bound {v * 1e3:.4f} ms"
                       for k, v in bounds.items() if k != name)
    host = ""
    if host_queue_s >= 0.8 * slab_s:
        host = (f"; the host needs {host_queue_s * 1e3:.4f} ms to queue a "
                "step's operations, so the device waits for the host")
    return (f"{name}-bound: a step takes {slab_s * 1e3:.4f} ms, "
            f"{slab_s / live[name]:.1f}x its {name} bound of "
            f"{live[name] * 1e3:.4f} ms ({others}){host}")


# the empty kernel that measures the launch floor: (blocks, threads)
FLOOR_GRID = (1024, 256)
FLOOR_LAUNCHES = 200
FLOOR_REPLAYS = 5


def launch_floor_s(dev) -> float:
    """Device seconds of one empty launch of FLOOR_GRID on the card
    ``dev``: a spin kernel holds the stream while the host queues
    FLOOR_LAUNCHES of them, and two events time them back to back."""
    import torch

    from ..ops import glfgen_kernels as K

    def launches():
        for _ in range(FLOOR_LAUNCHES):
            K.empty_launch(*FLOOR_GRID, dev)

    K.empty_launch(*FLOOR_GRID, dev)  # builds and loads the library
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    launches()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize(dev)
    # clock_rate is the top SM clock in kHz; at a lower clock the spin
    # only lasts longer
    clock_khz = torch.cuda.get_device_properties(dev).clock_rate
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.device(dev):
        torch.cuda._sleep(int((2 * host_s + 1e-3) * 1e3 * clock_khz))
        t0.record()
        launches()
        t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / 1e3 / FLOOR_LAUNCHES


def graph_launch_floor_s(dev) -> float:
    """Device seconds of one empty launch of FLOOR_GRID replayed from a
    CUDA graph that holds FLOOR_LAUNCHES of them: the launch floor of a
    graphed step, whose replay the host queues in one call."""
    import torch

    from ..ops import glfgen_kernels as K

    K.empty_launch(*FLOOR_GRID, dev)  # builds and loads the library
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev):
        with torch.cuda.graph(graph):
            for _ in range(FLOOR_LAUNCHES):
                K.empty_launch(*FLOOR_GRID, dev)
        graph.replay()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(FLOOR_REPLAYS):
            graph.replay()
        t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / 1e3 / (FLOOR_REPLAYS * FLOOR_LAUNCHES)


def bench_kernel(B: int = 8192, D: int = 48, iters: int = 16,
                 use_joint: bool = False, device=None) -> KernelBench:
    """Measure the rate of the production scoring step on ``device``:
    the card when None (``resolve_device("cuda")`` raises without one),
    the CPU only by name.  On a card the step is what the slab path
    replays (``models.step_graph.STEP_GRAPHS``), and the eager step is
    timed beside it on the same inputs; on the CPU both are the eager
    step, which is what the slab path runs there."""
    import torch

    from ..device import resolve_device
    from ..models.somatic import call_batch_packed
    from ..models.step_graph import STEP_GRAPHS
    from ..models.tables import ModelParams, build_tables, device_tables
    from ..ops import glfgen_kernels as K

    dev = resolve_device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    params = ModelParams(use_joint_priors=use_joint)
    dtabs = device_tables(build_tables(params), dev, "fast")
    stacked_h, meta_h = bench_inputs(B, D)
    stacked = torch.from_numpy(stacked_h.view(np.int32)).to(dev)
    meta = torch.from_numpy(meta_h).to(dev)

    steps_run = 0

    def eager(n: int):
        nonlocal steps_run
        steps_run += n
        prev = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(n):
            prev = call_batch_packed(stacked ^ (prev & 1), meta, dtabs,
                                     params).count

    graph = None
    if on_card:
        graph = STEP_GRAPHS.step(B, D, dtabs, params, dev)

        def graphed(n: int):
            # the same carry as the eager steps: the next step scores the
            # lanes flipped by the last count's low bit
            nonlocal steps_run
            steps_run += n
            for _ in range(n):
                graph.stacked ^= graph.count & 1
                graph.replay()
    else:
        graphed = eager

    def wait():
        if on_card:
            torch.cuda.synchronize(dev)

    def timed(steps, n: int) -> float:
        if not on_card:
            t0 = time.perf_counter()
            steps(n)
            return time.perf_counter() - t0
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        wait()
        t0.record()
        steps(n)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3

    lo, hi = max(2, iters // 4), iters

    def step_and_queue_s(steps) -> tuple[float, float]:
        """(seconds a step, seconds the host takes to queue one)."""
        t_lo = min(timed(steps, lo) for _ in range(2))
        t_hi = min(timed(steps, hi) for _ in range(2))
        wait()
        t0 = time.perf_counter()
        steps(hi)
        queue_s = (time.perf_counter() - t0) / hi
        wait()
        return max(t_hi - t_lo, 1e-9) / (hi - lo), queue_s

    eager(1)  # warm: kernel build, table cuts, allocator
    if graph is not None:
        graph.upload(stacked_h, meta_h)
        graph.replay()  # the first count, which the next step reads
        steps_run += 1
    wait()
    before = dict(K.LAUNCHES)
    n_ops = count_step_ops(lambda: eager(1))
    wait()
    kernel_launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                       if K.LAUNCHES[k] != before[k]}
    launches = n_ops + sum(kernel_launches.values())

    slab_s, host_queue_s = step_and_queue_s(graphed)
    eager_s, eager_queue_s = (step_and_queue_s(eager) if on_card
                              else (slab_s, host_queue_s))
    run_s = 0.0
    if on_card:
        t0 = time.perf_counter()
        for _ in range(hi):
            STEP_GRAPHS.run(stacked_h, meta_h, dtabs, params, dev)
        steps_run += hi
        run_s = (time.perf_counter() - t0) / hi
    cols_per_sec = B / slab_s
    floor_s = graph_launch_floor_s(dev) if on_card else 0.0
    stream_floor_s = launch_floor_s(dev) if on_card else 0.0

    f_port = port_flops_per_pair_column(D)
    tflops = cols_per_sec * f_port / 1e12
    bounds = {
        "launch": launches * floor_s,
        "byte": B * hbm_bytes_per_pair_column(D) / H100_HBM_BYTES_PER_S,
        "f32": B * f_port / H100_PEAK_F32_FLOPS,
    }
    verdict = (_verdict(slab_s, bounds, host_queue_s) if on_card else
               f"cpu run: a step takes {slab_s * 1e3:.4f} ms on the host; "
               "the bounds are the H100's and say nothing of it")
    return KernelBench(
        cols_per_sec=cols_per_sec, flops_per_col=flops_per_pair_column(D),
        tflops=tflops, est_mfu=tflops * 1e12 / H100_PEAK_F32_FLOPS,
        bound_compute_s=bounds["f32"], bound_hbm_s=bounds["byte"],
        measured_slab_s=slab_s, verdict=verdict, B=B, D=D,
        port_flops_per_col=f_port, launches_per_step=launches,
        kernel_launches=kernel_launches, launch_floor_s=floor_s,
        bound_launch_s=bounds["launch"], host_queue_s=host_queue_s,
        steps_run=steps_run, eager_slab_s=eager_s,
        eager_host_queue_s=eager_queue_s, graph_run_s=run_s,
        stream_launch_floor_s=stream_floor_s,
    )
