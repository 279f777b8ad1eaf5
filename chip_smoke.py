"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --score-sweep  # score_columns at small slabs

The second form times ``score_columns`` alone over slab sizes and depths that
``SNIPER_SLAB_B`` / ``SNIPER_SLAB_D`` reach; see ``score_sweep``.

Phases (each raises on failure, so a failed phase exits non-zero and the
closing ``{"ok": true, ...}`` line is never printed):

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the port's native host library (g++) and of the CUDA kernels
   (nvcc) from the sources under ``somatic_sniper_tpu_torch/``, the
   registers a thread of every kernel (``nvcc -Xptxas -v``), and the
   launch floor: the device time of an empty kernel of 1024 blocks of 256
   threads, queued back to back;
3. each kernel against its plain torch version on the card, with the
   median time of 20 timed calls of each: ``accumulate32`` and
   ``assembly10`` on random raw slabs at slab shapes; ``accumulate`` and
   ``accumulate16`` on random column batches from depth bucket 16 to
   8192 and an oversize column, plus the floored-rank hazard column, the
   assembly after the c_tot > 255 rescale, and the three rank kernels at
   the depths on both sides of every keys-per-lane step of the warp
   layout, with a batch size that fills no whole block, launched twice
   for equal bits; to depth 255 also the fused kernels ``glfgen32``,
   ``glfgen`` and ``glfgen16`` (an accumulate and the assembly in one
   launch) against ``assembly10_plain`` applied to the stand-alone
   accumulate kernel's sums: lk, min_lk, rms and n equal, two launches
   the same bits; and ``score_columns`` (consensus, score, gates,
   statuses and dqstats in one launch) against ``score_columns_plain``
   bit for bit, both priors, every gate flag, with the dqstats at the
   slab shapes and without at (65536, 40), timed; at (8192, 48) and
   (65536, 40) also timed with joint priors, each beside its byte and
   integer-issue bounds (``score_bounds``);
4. the main path at a size users run: the port's CLI on a simulated
   10 Mb tumor/normal pair at 30x (windowed driver), fast precision on
   the card against exact precision (native host scoring) under the fast
   contract, with the launch counters proving the run went through
   ``glfgen32`` twice a slab and through no stand-alone kernel, every
   slab a replay of the step's captured CUDA graph
   (``models/step_graph.py``), and its region loads' BGZF blocks through
   ``bgzf_inflate`` (``native.blocks_card`` > 0, none inflated again on
   the host, ``launches_bgzf_inflate`` counted where it is launched) and
   their pileups and pure-reference flags built through
   ``pileup_build`` (``native.regions_card_built`` > 0, none built on the
   host, ``launches_pileup_card`` a region at most); the windowed runs of
   phases 9, 10 and 15 are held to the same;
5. fast precision on the card against the golden pair's expected VCF;
6. the batch path with full-u32 batches (the no-reference route, with
   the reference's ref16 so sites emit) on the 10 Mb pair, whole-file,
   against phase 4's exact output, through ``glfgen`` (``accumulate``
   and ``assembly10`` only for batches deeper than 255); each batch's
   route (a key's first eager, later ones replays of its captured
   step, at least one replay; no retired eager route
   ``batches_eager_deep``) and the graph pool's MiB;
7. the port's CLI with the native library missing (pure-Python decode,
   u16 batches through ``glfgen16``) on a 1 Mb pair at 30x, in a
   child process, against the port's native exact output, with the
   child's routes and pool as in phase 6;
8. each kernel against its plain version again at every (B, D) its path
   ran in phases 4, 6 and 7 (read from the runs' per-depth counters),
   timed at the shape that carried the most columns: the times of the
   ``kernels`` line, each beside its bound (the least time the card
   could take: the bytes the inputs need over the memory rate, or the
   operations over the f32 rate, whichever is larger; for
   ``score_columns`` its integer operations over the INT32 rate);
   ``score_columns`` at every shape of each path, with the dqstats on
   the slab path's, and at each path's main shape with joint priors
   too.  A kernel faster than its bound is a fault of the count and
   fails the run;
9. ``--jobs 1``, ``2`` and ``4`` through the port's CLI, each in a child
   process, on the 10 Mb pair, fast on the card: output bytes equal to
   phase 4's; wall and cols/s of each beside the single process, every
   worker's start-up (spawn to first window) and stage times from its
   own summary, and every worker's ``glfgen32`` launches (a worker that
   launched none scored on the CPU: that fails);
10. two processes joined by ``SNIPER_COORDINATOR`` with ``--merge
    collective`` on the one card, same pair: the merged bytes equal to
    phase 4's, once at the default chunk and once at
    ``SNIPER_MERGE_CHUNK=4096``;
11. the exact f64 glfgen on the card: phase 6's full-u32 batch route
    with ``precision="exact"``, its lines byte-equal to phase 4's native
    exact output, its routes and pool as in phase 6, and the golden
    pair through the CLI with the native library missing, exact, equal
    to ``tests/data/expected.vcf``;
13. ``utils.mfu.bench_kernel`` on the card at (8192, 48), the production
    slab, and at (32768, 64): every step launched ``glfgen32`` twice,
    ``score_columns`` once and no stand-alone kernel, the slab step
    under 40 device operations; the same benchmark with
    ``score_columns_plain`` in the kernel's place (the step as torch
    ops) between two kernel runs, their device operations, graphed,
    eager and whole-call times side by side; one step's rows equal
    those of the same step through the plain versions on the card; the
    graphed step's time (as the slab path replays it), the eager step's
    beside it, the host's queue time of each and the whole production
    call of a slab, the rate, both FLOP counts, the three bounds and the
    verdict printed;
14. ``parallel.dryrun.entry()`` on the card: ``fn(*args)`` launches
    ``glfgen`` twice and every field equals ``entry("cpu")``'s (integer
    fields; a histogram of differences is printed if any);
15. records and ``prefilter``: the 10 Mb pair through
    ``call_pair_windows(fmt=None)``, its ``SniperRecord`` objects
    formatted by ``output.formatters`` byte-equal to phase 4's fast
    output; then ``prefilter=False``: the same bytes again while every
    column of the pair is scored, with the card's share of them, the
    slab depth and the stage times;
16. a card only where a path needs one: with ``CUDA_VISIBLE_DEVICES``
    empty and the default ``--device``, the exact CLI on the golden pair
    exits 0 with the golden bytes and never imports torch, and the fast
    CLI exits 1 with the device's message;
17. the captured step against the eager step: every slab depth the
    dispatcher can pick (``ALLOWED_D``) at B = 8192, with and without
    joint priors, two input sets back to back; count and rows equal
    byte for byte, the same launch counts; each capture's time, each
    key's device operations an eager step and replay ms (beside the
    torch-op step's recorded numbers) and the graph pool's device memory
    printed;
18. the captured batch step against the eager step: every (encoding,
    precision, B bucket, D) key that phases 6, 7 and 11 sent through
    the captured step, in a registry of its own, a key's first batch
    eager, then captured and replayed, on two input sets: count and
    rows byte-equal, the same launches; each key's capture ms, eager
    and graphed ms and the host's queue ms of each, its device
    operations an eager step beside the torch-op step's recorded replay ms,
    and the pool's MiB;
    a fast key of depth 300 among them; then a count pushed outside the
    assembly tables before that key's replay: its error word set, and
    ``collect_pending`` raising the stand-alone ``assembly10``'s
    ValueError;
20. ``bgzf_inflate`` at the region load's shape: every BGZF block of a
    250 kb window of the benchmark's generator at 30x (~210 blocks)
    through ``sniper_card_inflate``, byte-equal to zlib, one launch;
    its call ms beside host zlib's, its device ms (torch.profiler) and
    its byte bound in the ``kernels`` line;
21. the ``deep300`` configuration's pair (1 Mb at 300x a sample, the
    benchmark's generator) through the windowed driver, fast on the
    card: every survivor scored on the card in a slab deeper than 255
    (``device_columns_deep`` = ``device_columns`` = ``columns_scored``,
    ``host_deep_columns`` 0), every slab replayed, the second fast
    run's launches ``accumulate`` = ``assembly10`` = 2 x slabs and
    ``score_columns`` = slabs (launch counters reset before it), and the
    records within the fast contract of the native exact run;
22. the deep slab step's kernels at the shapes phase 21 ran (phase 8's
    ``kernels_at_path_shapes``, family ``deep``): ``accumulate`` over raw
    kept-only lanes with ``n_keep`` as the depth, ``assembly10`` after
    the c_tot > 255 rescale with the D-deep tables, and ``score_columns``
    with the dqstats over every lane, each against its plain version on
    columns 256-D deep and timed; the ``kernels`` line gives them under
    ``deep_slab`` in the ``accumulate``, ``assembly10`` and
    ``score_columns`` entries, with phase 21's launches;
23. ``pileup_build`` at the region load's shape: a 250 kb window of the
    benchmark's generator at 30x (phase 20's) and at 300x (the
    ``deep300`` configuration's), one sample, loaded through the native
    loader with the card builder registered and without: ukeys, offsets,
    slots and pure-reference flags byte-equal, one launch a load; the
    build's call ms (the loader's ``pileup_build`` seconds a load, the
    thread's wait on the card) beside the host build's, the four
    kernels' device ms (torch.profiler) and their byte bound in the
    ``kernels`` line (the 300x window under ``deep_window``).

Numbers 12 and 19 are not used.

``python3 chip_smoke.py --deep`` runs phases 1, 2, 17 at the slab tiers
from 255 up, 21 and 22; ``python3 chip_smoke.py --pileup`` phases 1, 2
and 23.

Its first statements make ``import jax`` and ``import somatic_sniper_tpu``
fail, so a pass also shows that the port needs neither; it imports only
the port (``somatic_sniper_tpu_torch``).  The simulated pair is cached
in ``chip_smoke_data/`` (gitignored) and regenerated when missing.
"""

import sys

sys.modules["jax"] = None  # any import of JAX from here on raises
sys.modules["somatic_sniper_tpu"] = None  # and any of the JAX package

import functools  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, NamedTuple  # noqa: E402

REPO = Path(__file__).resolve().parent
DATA = REPO / "chip_smoke_data"
GOLDEN = REPO / "tests" / "data"
SHAPES = [(8192, 16), (8192, 32), (8192, 48), (8192, 64), (8192, 128),
          (1024, 255)]
TIMED_RUNS = 20  # back-to-back calls per timing
TIMED_REPEATS = 5  # timings per median
# the batch path's shapes: max_batch columns at the shallow buckets,
# fewer at the deep ones, and one oversize column pair at its own depth
RANK_SHAPES = [(65536, 16), (65536, 32), (65536, 40), (65536, 48),
               (16384, 128), (4096, 256), (512, 1024), (64, 8192),
               (2, 20000)]
# the warp layout holds 1, 2, 4 or 8 keys a lane (P = 32 .. 256): the
# depths on both sides of each step, and a B that fills no whole block
EDGE_DEPTHS = [1, 31, 32, 33, 40, 48, 64, 65, 96, 128, 129, 255, 256]
EDGE_B = 1001
# published peaks of the H100 SXM: HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the H100 SXM's SMs and the INT32 lanes of each (64 integer operations an
# SM a clock: CUDA C++ Programming Guide, arithmetic instructions, cc 9.0)
H100_SMS = 132
INT32_LANES_PER_SM = 64
# Integer operations of score_columns.cu, counted from its source after
# unrolling, as the fewest Hopper instructions each needs: an add of up to
# three terms, a min, max or abs, a compare (with the predicates it
# combines), a select, a shift or mask, a multiply(-add) is one, a clamp
# two; loads, stores, addresses and loop counters are left out.  qadd:
# y - x, the clamp, abs, min(d, 0), three compares, the sum.  glf2cns, a
# sample: six het penalties, the three scans (9 x 3, 10 x 4, 10 x 4), the
# gaps, caps, bases and the n == 0 guard.  solo: the prior adds and post
# caps of both samples (60) and the fold's sums (10), beside its 30 qAdds.
# joint: 100 x (sum, cap, compare, the select of the best and the select
# of its flat index 10 i + j, both constants after unrolling), the index
# split into i and j (3), 10 x (sum, cap, subtract, compare, select), the
# two bases and the cap, beside its 120 qAdds.  gates: the depth caps, the SNP gate, the VAQs, the effective
# genotypes, LOH/GOR, emit and the statuses.  dq_lane, a lane: the
# wrapping walk (3), four field extracts, the mapQ sum, the dp4 byte (5),
# the base bytes (7) and their sum, the two 16-bit spreads (4) and four
# multiply-adds.  dq_row, a sample's row: the skewed start, a chunk's
# unpacking into the totals (40), the integer part of nine _mean_499
# (126) and the wanted masks (16).
SCORE_INT_OPS = {"qadd": 9, "glf2cns": 126, "solo": 70, "joint": 558,
                 "gates": 38, "dq_lane": 29, "dq_row": 183}
# f32 operations a column of assembly10 takes (counted from its plain
# version: ten genotype sums, the two scans, the quantization)
ASSEMBLY_FLOPS_PER_COLUMN = 220
SIM = dict(n_contigs=2, contig_len=5_000_000, mean_depth=30.0, seed=11)
SIM_1MB = dict(n_contigs=1, contig_len=1_000_000, mean_depth=30.0, seed=12)
CSRC = "somatic_sniper_tpu_torch/ops/csrc/"
PALLAS = "somatic_sniper_tpu/ops/pallas_glfgen.py"
# name: (source, the TPU kernel or kernels it replaces)
KERNELS = {
    "accumulate32": (CSRC + "accumulate32.cu", PALLAS + ":578"),
    "assembly10": (CSRC + "assembly10.cu", PALLAS + ":526"),
    "accumulate": (CSRC + "accumulate.cu", PALLAS + ":717"),
    "accumulate16": (CSRC + "accumulate16.cu", PALLAS + ":652"),
    # an accumulate and the assembly in one launch (depth <= 255)
    "glfgen32": (CSRC + "accumulate32.cu", f"{PALLAS}:578 and {PALLAS}:526"),
    "glfgen": (CSRC + "accumulate.cu", f"{PALLAS}:717 and {PALLAS}:526"),
    "glfgen16": (CSRC + "accumulate16.cu", f"{PALLAS}:652 and {PALLAS}:526"),
    # no Pallas kernel: the XLA fusions of the jitted call_batch after its
    # glfgen (consensus, score, gates, statuses, dqstats)
    "score_columns": (CSRC + "score_columns.cu",
                      "somatic_sniper_tpu/models/somatic.py:130 (call_batch "
                      "after glfgen; consensus.py:41-211, somatic.py:62-128)"),
    # no TPU kernel: its plain version is the host's zlib inflate
    "bgzf_inflate": (CSRC + "bgzf_inflate.cu",
                     "none: host zlib in somatic_sniper_tpu/io/native/"
                     "sniper_native.cpp region_scan"),
    # no TPU kernel: its plain version is the host's counting build
    "pileup_build": (CSRC + "pileup_build.cu",
                     "none: host pileup_build_tpl and fill_pure_flags in "
                     "somatic_sniper_tpu/io/native/sniper_native.cpp"),
}
# the CUDA kernels each entry of KERNELS launches, where they are not
# named after it
KERNEL_FUNCS = {"pileup_build": ("pileup_cover_kernel", "pileup_scan_kernel",
                                 "pileup_scatter_kernel",
                                 "pileup_pure_kernel")}
# the fused kernel that runs a stand-alone kernel's code on each path
FUSED_AS = {"accumulate32": "glfgen32", "assembly10": "glfgen32",
            "accumulate": "glfgen", "accumulate16": "glfgen16"}
# the empty kernel that measures the launch floor: (blocks, threads)
FLOOR_GRID = (1024, 256)
# the scoring step before score_columns (consensus, score, gates and
# dqstats as torch ops), as PERF.md records it on an H100 80GB HBM3 at
# 700 W: ~1234 device operations an eager slab step, a slab replay of
# 2.07-2.27 ms at (8192, 48), a batch replay of 0.86-1.35 ms fast and
# 2.4-10.3 ms exact
TORCH_OP_STEP = {"slab_ops": 1234, "slab_replay_ms": "2.07-2.27",
               "batch_replay_ms_fast": "0.86-1.35",
               "batch_replay_ms_exact": "2.4-10.3"}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def random_slab_lanes(B: int, D: int, seed: int):
    """Raw kept-only lanes drawn like the repo's kernel tests: every base
    code class, zero base qualities, every mapQ, deletions dropped and
    the kept lanes left-packed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    depth = rng.integers(0, D + 1, B)
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04]).astype(np.uint32)
    baseq = np.where(rng.random((B, D)) < 0.05, 0,
                     rng.integers(0, 94, (B, D))).astype(np.uint32)
    mapq = rng.integers(0, 256, (B, D)).astype(np.uint32)
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    words = mapq | (baseq << 8) | (base << 16) | (strand << 20)
    keep = (np.arange(D)[None, :] < depth[:, None]) & \
        (rng.random((B, D)) >= 0.05)
    order = np.argsort(~keep, axis=1, kind="stable")
    slots = np.take_along_axis(np.where(keep, words, 0), order, axis=1)
    ref16 = rng.choice([1, 2, 4, 8, 15], size=B)
    return (slots.astype(np.int32), keep.sum(axis=1).astype(np.int32),
            ref16.astype(np.int32))


def random_u32_lanes(B: int, D: int, seed: int):
    """Full u32 slot words drawn like tests/test_pallas.py: deletions
    stay among the first ``depth`` lanes.  Returns (slots int32 [B, D],
    depth int32 [B], ref16 int32 [B])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    depth = rng.integers(0, D + 1, B).astype(np.int32)
    depth[0] = D  # one full column per batch
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04]).astype(np.uint32)
    baseq = np.where(rng.random((B, D)) < 0.05, 0,
                     rng.integers(0, 94, (B, D))).astype(np.uint32)
    mapq = rng.integers(0, 256, (B, D)).astype(np.uint32)
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    is_del = (rng.random((B, D)) < 0.05).astype(np.uint32)
    words = (mapq | (baseq << 8) | (base << 16) | (strand << 20)
             | (is_del << 21))
    slots = np.where(np.arange(D)[None, :] < depth[:, None], words, 0)
    ref16 = rng.choice([1, 2, 4, 8, 15], size=B).astype(np.int32)
    return slots.astype(np.uint32).view(np.int32), depth, ref16


def packed16_lanes(slots, depth, ref16, cap_mapq: int = 60):
    """Full slot words -> compact u16 lanes as tests/test_pallas.py
    _to_packed16 builds them.  Returns (slots16 uint16 [B, D], n_keep
    int32 [B])."""
    import numpy as np

    B, D = slots.shape
    s = slots.view(np.uint32)
    keep = ((np.arange(D)[None, :] < depth[:, None])
            & (((s >> 21) & 1) == 0))
    mq = (s & 0xFF).astype(np.int32)
    q = ((s >> 8) & 0xFF).astype(np.int32)
    b16 = ((s >> 16) & 0xF).astype(np.int32)
    code = np.where(b16 != 0, b16, ref16[:, None])
    base2 = np.select([code == 2, code == 4, code == 8], [1, 2, 3], 0)
    eff = np.minimum(q, mq)
    eff = np.where((eff < 4) & ((q & 0x3F) != 0), 4, eff)
    val = eff | (base2 << 8) | (((s >> 20) & 1).astype(np.int32) << 10)
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(np.where(keep, val, 0), order, axis=1)
    return out.astype(np.uint16), keep.sum(axis=1).astype(np.int32)


def call_ms(fn, torch) -> float:
    """Milliseconds per call: TIMED_RUNS back-to-back calls between two
    CUDA events, divided by TIMED_RUNS; the median of TIMED_REPEATS such
    timings after a warm-up.  The wrapper's host work and launches are
    inside: it is what one call costs its caller."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_REPEATS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(TIMED_RUNS):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / TIMED_RUNS)
    return statistics.median(times)


def queued_ms(fn, torch) -> float | None:
    """Device milliseconds per call.  A spin kernel holds the stream
    while the host queues TIMED_RUNS calls; two CUDA events then time
    them back to back on the device (launch gaps included), divided by
    TIMED_RUNS; the median of TIMED_REPEATS.  None ("not measured") when
    the timed calls started before the host had queued them all: a call
    waited for the device, as the plain versions that read a value back
    do (assembly10_plain checks its counts on the host)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TIMED_RUNS):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    # clock_rate is the top SM clock in kHz; at a lower clock the spin
    # only lasts longer
    cycles = int((2 * host_s + 1e-3) * 1e3 *
                 torch.cuda.get_device_properties(0).clock_rate)
    times = []
    for _ in range(TIMED_REPEATS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(TIMED_RUNS):
            fn()
        t1.record()
        if t0.query():
            torch.cuda.synchronize()
            return None
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / TIMED_RUNS)
    return statistics.median(times)


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_sums(name, k, p, shape, torch) -> float:
    """esum/fsum of kernel against plain within the stated tolerance:
    rtol 1e-6, atol 1e-5 to D = 255, rtol 1e-4 above (f32 sums of
    thousands of terms in another order); returns the max abs error."""
    rtol = 1e-6 if shape[1] <= 255 else 1e-4
    for a, b, what in ((k[0], p[0], "esum"), (k[1], p[1], "fsum")):
        if not torch.allclose(a, b, rtol=rtol, atol=1e-5):
            raise AssertionError(
                f"{name} {what} outside rtol {rtol}, atol 1e-5 at {shape}: "
                f"max abs err {float((a - b).abs().max())}")
    return max(float((k[0] - p[0]).abs().max()),
               float((k[1] - p[1]).abs().max()))


def bound_ms(n_bytes: int, flops: int) -> tuple[float, str]:
    """The least milliseconds the card could take to move ``n_bytes``
    (each input read once, each output written once) or to do ``flops``
    f32 operations, whichever is larger, and which of the two it is."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def rank_bound(lanes: int, lane_bytes: int, B: int, words_in: int,
               words_out: int, taken: int) -> tuple[float, str]:
    """Bound of a rank kernel on this batch: the ``lanes`` occupied
    lanes (the kernel needs no others) of ``lane_bytes`` each,
    ``words_in`` and ``words_out`` 4-byte words per column, the 1 KB
    weight table; a multiply and two adds per lane taken in.  The
    rank's comparisons are integer work with no published peak and are
    left out."""
    return bound_ms(lanes * lane_bytes + 4 * B * (words_in + words_out)
                    + 1024, 3 * taken)


def assembly_table_bytes(tables, B: int) -> int:
    """Bytes of the assembly tables a batch of B columns can touch: ten
    coef and six lhet reads a column, at most the whole tables."""
    return min(4 * sum(t.numel() for t in tables), 64 * B)


def assembly_bound(B: int, tables) -> tuple[float, str]:
    """Bound of assembly10 on B columns: three [B, 4] arrays and n in,
    lk[10], min_lk and the error word out, and the table entries the
    gathers can touch."""
    return bound_ms(4 * B * (13 + 11) + 4 + assembly_table_bytes(tables, B),
                    ASSEMBLY_FLOPS_PER_COLUMN * B)


def fused_bound(lanes: int, lane_bytes: int, B: int, words_in: int,
                words_out: int, taken: int, tables) -> tuple[float, str]:
    """Bound of a fused kernel on this batch: the rank's occupied lanes
    and ``words_in`` words a column in, lk[10], min_lk and what else it
    writes (``words_out`` words a column) out, the 1 KB weight table and
    the table entries the gathers can touch; esum, fsum and c make no
    round trip.  Operations: the rank's and the assembly's."""
    return bound_ms(lanes * lane_bytes + 4 * B * (words_in + words_out)
                    + 1024 + assembly_table_bytes(tables, B),
                    3 * taken + ASSEMBLY_FLOPS_PER_COLUMN * B)


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


def score_int_ops(B: int, lanes: int, dq: bool, joint: bool) -> int:
    """Integer operations score_columns needs on B columns (``lanes``
    occupied kept lanes in all, with the dqstats), counted from
    score_columns.cu by SCORE_INT_OPS' rules."""
    ops = SCORE_INT_OPS
    q = ops["qadd"]
    per_col = (2 * ops["glf2cns"] + ops["gates"]
               + (ops["joint"] + 120 * q if joint else ops["solo"] + 30 * q))
    if dq:
        per_col += 2 * ops["dq_row"]
    return B * per_col + (ops["dq_lane"] * lanes if dq else 0)


def score_bounds(B: int, lanes: int, dq: bool, joint: bool) -> dict:
    """Bounds of score_columns on B columns.  Bytes: 2 x 10 likelihoods,
    the two raw depths, glfgen's two counts and ref16 in (25 words a
    column), the emit byte and 16 fields out, and the prior (640 bytes
    solo, 6.4 KB joint); with the dqstats also both samples' n_keep and
    their ``lanes`` occupied lanes in, 36 words a column out; over the
    memory rate.  Integer issue: score_int_ops over 132 SMs x 64 INT32
    lanes x the maximum SM clock.  (The two f32 operations of each of the
    18 means a column are far below both.)  Returns both, the larger
    as ``bound_ms`` with ``bound_by``."""
    n_bytes = 4 * B * 25 + B * (1 + 64) + 4 * (1600 if joint else 160)
    flops = 0
    if dq:
        n_bytes += 4 * B * 2 + 4 * lanes + 4 * B * 36
        flops = 2 * 18 * B
    by_bytes, _ = bound_ms(n_bytes, flops)
    int_ops = score_int_ops(B, lanes, dq, joint)
    by_int = int_ops / (H100_SMS * INT32_LANES_PER_SM * max_sm_clock_hz()) \
        * 1e3
    bound, by = (by_bytes, "bytes") if by_bytes >= by_int \
        else (by_int, "operations")
    return {"bound_ms": bound, "bound_by": by, "byte_bound_ms": by_bytes,
            "bytes": n_bytes, "int_bound_ms": by_int, "int_ops": int_ops,
            "max_sm_mhz": max_sm_clock_hz() / 1e6}


def score_args(B: int, D: int, seed: int, hi: int, dev, torch):
    """score_columns' per-column inputs at (B, D), drawn like the slab
    lanes: likelihoods in [0, hi) (a small hi forces ties), the raw
    depth one more than the kept lanes where any are kept, glfgen's
    count n_keep, ref16 from the lanes with every 97th column 15.
    Returns (lk_t, lk_n, depth_t, depth_n, n_t, n_n, ref16, (slots_t,
    nk_t, slots_n, nk_n)) on ``dev``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s_t, nk_t, ref16 = random_slab_lanes(B, D, seed)
    s_n, nk_n, _ = random_slab_lanes(B, D, seed + 1000)
    ref16[::97] = 15
    arrays = (rng.integers(0, hi, (B, 10)).astype(np.int32),
              rng.integers(0, hi, (B, 10)).astype(np.int32),
              nk_t + (nk_t > 0), nk_n + (nk_n > 0), nk_t, nk_n, ref16)
    on = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
          for a in (*arrays, s_t, nk_t, s_n, nk_n)]
    return (*on[:7], tuple(on[7:]))


def score_case(B: int, D: int, dev, torch, dq: bool, joint: bool = False,
               check: bool = True) -> "Case":
    """score_columns against score_columns_plain on the card at (B, D),
    bit for bit (emit, the 16 fields and, with ``dq``, both dqstats
    rows).  With ``check``: both priors, every gate flag each way,
    tie-heavy and full likelihood ranges, two launches the same bits.
    Timed with the default parameters, joint priors if ``joint``, on the
    full range, whose result is held to the plain version too."""
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import score_kernels as sk

    def equal(got, again, want, what):
        torch.cuda.synchronize()
        for name, a, a2, b in zip(got._fields, got, again, want):
            if (a is None) != (b is None) or (a is not None and not (
                    torch.equal(a, b) and torch.equal(a, a2))):
                raise AssertionError(
                    f"score_columns {name} differs from its plain version "
                    f"at {(B, D)}: {what}, dq {dq}")

    for use_joint in ((False, True) if check else ()):
        dtabs = device_tables(build_tables(ModelParams(
            use_joint_priors=use_joint)), dev)
        for hi in (4, 256):
            *cols, lanes = score_args(B, D, B + D + hi, hi, dev, torch)
            for loh, gor in ((True, True), (False, True), (True, False),
                             (False, False)):
                params = ModelParams(use_joint_priors=use_joint,
                                     include_loh=loh, include_gor=gor)
                args = (*cols, dtabs.solo_prior, dtabs.joint_prior,
                        dtabs.q_r_int, params, lanes if dq else None)
                equal(sk.score_columns(*args), sk.score_columns(*args),
                      sk.score_columns_plain(*args),
                      f"joint {use_joint}, hi {hi}, include_loh {loh}, "
                      f"include_gor {gor}")
    params = ModelParams(use_joint_priors=joint)
    dtabs = device_tables(build_tables(params), dev)
    *cols, lanes = score_args(B, D, B + D, 256, dev, torch)
    args = (*cols, dtabs.solo_prior, dtabs.joint_prior, dtabs.q_r_int,
            params, lanes if dq else None)
    equal(sk.score_columns(*args), sk.score_columns(*args),
          sk.score_columns_plain(*args), f"timed inputs, joint {joint}")
    occupied = int(lanes[1].clamp(min=0, max=D).sum()
                   + lanes[3].clamp(min=0, max=D).sum())
    bounds = score_bounds(B, occupied, dq, joint)
    return Case(0.0, lambda: sk.score_columns(*args),
                lambda: sk.score_columns_plain(*args),
                (bounds["bound_ms"], bounds["bound_by"]), detail=bounds)


def score_joint(B: int, D: int, dq: bool, dev, torch,
                floor_ms: float) -> tuple:
    """score_columns at (B, D) with joint priors (its <1, dq> instance),
    held to its plain version and timed: timed(...)'s tuple."""
    return timed("score_columns joint", (B, D),
                 score_case(B, D, dev, torch, dq, joint=True, check=False),
                 torch, floor_ms)


class Case(NamedTuple):
    """One kernel at one shape, checked against its plain version."""

    err: float          # max abs error against the plain version
    kernel: Callable    # the wrapper call a path makes
    plain: Callable
    bound: tuple[float, str]  # (bound_ms, bound_by)
    # the same launch without the wrapper's wait for the device, where
    # the wrapper has one: what the device time is taken from
    launch: Callable | None = None
    # more numbers of the case for the kernels line (score_columns: its
    # byte and integer-issue bounds)
    detail: dict | None = None


def check_fused(name: str, got, again, want, shape, torch) -> None:
    """A fused kernel's outputs, of two launches, against ``want``:
    assembly10_plain on the stand-alone accumulate kernel's sums, then
    that kernel's rms and n.  Every one must be equal."""
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name} returned {len(got)} arrays")
    for what, a, a2, b in zip(("lk", "min_lk", "rms", "n"), got, again, want):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name} {what} differs from the two-step result at {shape}")
        if not torch.equal(a, a2):
            raise AssertionError(f"two {name} launches differ at {shape}")


def slab_cases(B: int, D: int, dtabs, dev, torch) -> dict:
    """accumulate32, then assembly10 on its sums, against their plain
    versions on random raw slab lanes at (B, D) (c, rms, lk and min_lk
    equal), and glfgen32, the two in one launch, against the same lk,
    min_lk and rms.  Returns {name: Case}."""
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    s, nk, r = (torch.from_numpy(a).to(dev)
                for a in random_slab_lanes(B, D, seed=D))
    w = dtabs.fk_weights
    k = gk.accumulate32(s, nk, r, w, 60)
    p = gk.accumulate32_plain(s, nk, r, w, 60)
    torch.cuda.synchronize()
    if not (torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])):
        raise AssertionError(f"accumulate32 c/rms differ at {(B, D)}")
    acc_err = check_sums("accumulate32", k, p, (B, D), torch)
    args = (k[0], k[1], k[2], nk, *dtabs.assembly_tables(D))
    lk, mlk = gk.assembly10(*args)
    lk_p, mlk_p = gk.assembly10_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)):
        raise AssertionError(f"assembly10 lk/min_lk differ at {(B, D)}")
    k2 = gk.accumulate32(s, nk, r, w, 60)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k, k2)):
        raise AssertionError(f"two accumulate32 launches differ at {(B, D)}")
    tables = args[4:]

    def fused():
        return gk.glfgen32(s, nk, r, w, *tables, 60)

    got = fused()
    check_fused("glfgen32", got, fused(), (lk_p, mlk_p, k[3]), (B, D), torch)
    lanes = int(nk.clamp(max=D).sum())
    taken = int(k[2].sum())
    return {
        "accumulate32": Case(acc_err, lambda: gk.accumulate32(s, nk, r, w, 60),
                             lambda: gk.accumulate32_plain(s, nk, r, w, 60),
                             rank_bound(lanes, 4, B, 2, 13, taken)),
        "assembly10": Case(
            float((lk - lk_p).abs().max()), lambda: gk.assembly10(*args),
            lambda: gk.assembly10_plain(*args), assembly_bound(B, tables),
            launch=lambda: gk.assembly10_launch(*args)),
        # n_keep and ref16 in; lk[10], min_lk and rms out
        "glfgen32": Case(
            float((got[0] - lk_p).abs().max()), fused,
            lambda: gk.glfgen32_plain(s, nk, r, w, *tables, 60),
            fused_bound(lanes, 4, B, 2, 12, taken, tables)),
    }


def rank_cases(B: int, D: int, dtabs, dev, torch,
               names=("accumulate", "accumulate16")) -> dict:
    """accumulate (full u32 slots, deletions included) and accumulate16
    (the same columns as u16 lanes) against their plain versions at
    (B, D): c, rms and n equal, the sums within check_sums; past D = 255
    also assembly10 after the c_tot > 255 rescale; a second launch of
    each gives the same bits.  To D = 255 also their fused kernels,
    glfgen and glfgen16, against assembly10_plain on the stand-alone
    kernel's sums (lk, min_lk, rms and n equal).  Returns {name: Case}."""
    from somatic_sniper_tpu_torch.models.glfgen import rescale_counts
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    w = dtabs.fk_weights
    slots, depth, ref16 = random_u32_lanes(B, D, seed=D + 1)
    cases = {}
    if "accumulate" in names:
        s, dp, r = (torch.from_numpy(a).to(dev) for a in (slots, depth, ref16))
        k = gk.accumulate(s, dp, r, w, 60)
        p = gk.accumulate_plain(s, dp, r, w, 60)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k[2:], p[2:])):
            raise AssertionError(f"accumulate c/rms/n differ at {(B, D)}")
        err = check_sums("accumulate", k, p, (B, D), torch)
        if D > 255:
            args = (k[0], k[1], rescale_counts(k[2]), k[4],
                    *dtabs.assembly_tables(D))
            lk, mlk = gk.assembly10(*args)
            lk_p, mlk_p = gk.assembly10_plain(*args)
            torch.cuda.synchronize()
            if not (torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)):
                raise AssertionError(
                    f"assembly10 after the rescale differs at {(B, D)}")
            print(f"  assembly10 after the rescale B={B} D={D}: equal, "
                  f"{int((k[2].sum(dim=1) > 255).sum())} columns rescaled",
                  flush=True)
        k2 = gk.accumulate(s, dp, r, w, 60)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k, k2)):
            raise AssertionError(f"two accumulate launches differ at {(B, D)}")
        lanes, taken = int(depth.clip(0, D).sum()), int(k[2].sum())
        cases["accumulate"] = Case(
            err, lambda: gk.accumulate(s, dp, r, w, 60),
            lambda: gk.accumulate_plain(s, dp, r, w, 60),
            rank_bound(lanes, 4, B, 2, 14, taken))
        if D <= 255:
            tables = dtabs.assembly_tables(D)

            def fused():
                return gk.glfgen_u32(s, dp, r, w, *tables, 60)

            asm = (k[0], k[1], k[2], k[4], *tables)
            lk_p, mlk_p = gk.assembly10_plain(*asm)
            lk, mlk = gk.assembly10(*asm)
            if not (torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)):
                raise AssertionError(f"assembly10 lk/min_lk differ at {(B, D)}")
            want = (lk_p, mlk_p, k[3], k[4])
            got = fused()
            check_fused("glfgen", got, fused(), want, (B, D), torch)
            # what the second launch of the two-step route costs here
            cases["assembly10"] = Case(
                float((lk - lk_p).abs().max()), lambda: gk.assembly10(*asm),
                lambda: gk.assembly10_plain(*asm),
                assembly_bound(B, tables),
                launch=lambda: gk.assembly10_launch(*asm))
            # depth and ref16 in; lk[10], min_lk, rms and n out
            cases["glfgen"] = Case(
                float((got[0] - want[0]).abs().max()), fused,
                lambda: gk.glfgen_u32_plain(s, dp, r, w, *tables, 60),
                fused_bound(lanes, 4, B, 2, 13, taken, tables))
    if "accumulate16" in names:
        s16, nk = packed16_lanes(slots, depth, ref16)
        l16, n16 = (torch.from_numpy(a).to(dev) for a in (s16, nk))
        k16 = gk.accumulate16(l16, n16, w)
        p16 = gk.accumulate16_plain(l16, n16, w)
        torch.cuda.synchronize()
        if not torch.equal(k16[2], p16[2]):
            raise AssertionError(f"accumulate16 c differs at {(B, D)}")
        k16_2 = gk.accumulate16(l16, n16, w)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k16, k16_2)):
            raise AssertionError(
                f"two accumulate16 launches differ at {(B, D)}")
        lanes16, taken16 = int(nk.clip(0, D).sum()), int(k16[2].sum())
        cases["accumulate16"] = Case(
            check_sums("accumulate16", k16, p16, (B, D), torch),
            lambda: gk.accumulate16(l16, n16, w),
            lambda: gk.accumulate16_plain(l16, n16, w),
            rank_bound(lanes16, 2, B, 1, 12, taken16))
        if D <= 255:
            tables16 = dtabs.assembly_tables(D)

            def fused16():
                return gk.glfgen16(l16, n16, w, *tables16)

            want16 = gk.assembly10_plain(*k16, n16, *tables16)
            got16 = fused16()
            check_fused("glfgen16", got16, fused16(), want16, (B, D), torch)
            # n_keep in; lk[10] and min_lk out
            cases["glfgen16"] = Case(
                float((got16[0] - want16[0]).abs().max()), fused16,
                lambda: gk.glfgen16_plain(l16, n16, w, *tables16),
                fused_bound(lanes16, 2, B, 1, 11, taken16, tables16))
    return cases


def timed(name: str, shape, case: Case, torch, floor_ms: float) -> tuple:
    """(max_abs_err, ms, plain_ms, device_ms, plain_device_ms, bound_ms,
    bound_by, detail) of one case, printed beside the launch floor
    ``floor_ms``.
    A kernel that beats its bound shows a fault of the count: that
    raises."""
    err, kern, plain, (bound, by), launch, detail = case
    t = (err, call_ms(kern, torch), call_ms(plain, torch),
         queued_ms(launch or kern, torch), queued_ms(plain, torch), bound, by,
         detail)
    share = "" if t[3] is None else f" ({100 * bound / t[3]:.1f}% of it)"
    print(f"  {name:13s} B={shape[0]:5d} D={shape[1]:5d}  max_abs_err={err:.3g}"
          f"  per call: kernel {t[1]:.4f} ms, plain {t[2]:.4f} ms; "
          f"device: kernel {fmt_ms(t[3])}, plain {fmt_ms(t[4])}; "
          f"bound {bound:.5f} ms by {by}{share}; launch floor "
          f"{fmt_ms(floor_ms)}", flush=True)
    if detail is not None:
        print(f"    bounds: bytes {detail['byte_bound_ms']:.5f} ms "
              f"({detail['bytes']} B), integer issue "
              f"{detail['int_bound_ms']:.5f} ms ({detail['int_ops']} "
              f"operations at {detail['max_sm_mhz']:.0f} MHz)", flush=True)
    if bound > min(x for x in (t[1], t[3]) if x is not None):
        raise AssertionError(
            f"{name} at {shape} ran faster than its bound of {bound} ms: "
            "the bound's count is wrong")
    return t


def hazard_check(dtabs, dev, torch) -> float:
    """The floored-rank hazard: class A, (baseQ, mapQ) = (64, 3), (1, 0),
    (30, 60); the reference ranks by raw eff (esum[A] = 35.4868), the
    Pallas kernel by the floored one (35.610474).  Returns the max abs
    error against the plain version."""
    import numpy as np

    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    w = dtabs.fk_weights
    hz = np.array([[3 | 64 << 8 | 1 << 16, 0 | 1 << 8 | 1 << 16,
                    60 | 30 << 8 | 1 << 16]], np.int32)
    s, dp, r = (torch.from_numpy(a).to(dev) for a in
                (hz, np.array([3], np.int32), np.array([1], np.int32)))
    k = gk.accumulate(s, dp, r, w, 60)
    p = gk.accumulate_plain(s, dp, r, w, 60)
    torch.cuda.synchronize()
    err = check_sums("accumulate", k, p, (1, 3), torch)
    if not (all(torch.equal(a, b) for a, b in zip(k[2:], p[2:]))
            and abs(float(k[0][0, 0]) - 35.4868) < 1e-4):
        raise AssertionError("accumulate does not rank by the raw eff")
    print(f"  accumulate hazard column: esum[A] {float(k[0][0, 0]):.6f} "
          f"(raw-eff rank), max_abs_err {err:.3g}", flush=True)
    return err


def path_shapes(stats: dict, prefix: str, B_of) -> list[tuple[int, int]]:
    """The (B, D) shapes a run gave a kernel, from its per-depth
    counters ``<prefix><D>``, most-used first: B_of(count) is the batch
    size at that depth."""
    cnt = {int(k[len(prefix):]): v for k, v in stats.items()
           if k.startswith(prefix)}
    if not cnt:
        raise AssertionError(f"the run recorded no {prefix}* counter")
    return [(B_of(v), D) for D, v in sorted(cnt.items(),
                                            key=lambda kv: -kv[1])]


def deep_slab_lanes(B: int, D: int, seed: int):
    """Raw kept-only lanes of one sample, every column 256-D reads deep
    (so every class total takes the c_tot > 255 rescale): the first half
    drawn like random_slab_lanes (every base code, every mapQ, some zero
    base qualities), the second half with base qualities 2-9, mapQ 60 and
    the reads split between the reference base and one other, which
    leaves likelihoods strictly between 0 and 255.  Returns (slots int32
    [B, D], n_keep int32 [B], ref16 int32 [B])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nk = rng.integers(256, D + 1, B).astype(np.int32)
    ref16 = rng.choice([1, 2, 4, 8], size=B).astype(np.int32)
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04]).astype(np.uint32)
    baseq = np.where(rng.random((B, D)) < 0.05, 0,
                     rng.integers(0, 94, (B, D))).astype(np.uint32)
    mapq = rng.integers(0, 256, (B, D)).astype(np.uint32)
    half = B // 2
    alt = np.roll(ref16, 1)[half:, None].astype(np.uint32)
    frac = rng.uniform(0.2, 0.8, (B - half, 1))
    base[half:] = np.where(rng.random((B - half, D)) < frac, alt,
                           ref16[half:, None].astype(np.uint32))
    baseq[half:] = rng.integers(2, 10, (B - half, D))
    mapq[half:] = 60
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    words = mapq | (baseq << 8) | (base << 16) | (strand << 20)
    slots = np.where(np.arange(D)[None, :] < nk[:, None], words, 0)
    return slots.astype(np.uint32).view(np.int32), nk, ref16


def deep_slab_cases(B: int, D: int, dtabs, dev, torch) -> dict:
    """The deep slab step's kernels at (B, D), D > 255, as the captured
    step runs them a sample: ``accumulate`` over raw kept-only lanes with
    ``n_keep`` as the depth (c, rms and n equal to the plain version, the
    sums within check_sums, a second launch the same bits), then
    ``assembly10`` on its sums after the c_tot > 255 rescale, with the
    D-deep tables (lk and min_lk equal to the plain version, the error
    word 0).  Returns {name: Case}."""
    from somatic_sniper_tpu_torch.models.glfgen import rescale_counts
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    w = dtabs.fk_weights
    s, nk, r = (torch.from_numpy(a).to(dev)
                for a in deep_slab_lanes(B, D, seed=D + 3))
    k = gk.accumulate(s, nk, r, w, 60)
    p = gk.accumulate_plain(s, nk, r, w, 60)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k[2:], p[2:])):
        raise AssertionError(f"deep accumulate c/rms/n differ at {(B, D)}")
    err = check_sums("accumulate", k, p, (B, D), torch)
    k2 = gk.accumulate(s, nk, r, w, 60)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k, k2)):
        raise AssertionError(f"two deep accumulate launches differ at "
                             f"{(B, D)}")
    rescaled = rescale_counts(k[2])
    tables = dtabs.assembly_tables(D)
    args = (k[0], k[1], rescaled, k[4], *tables)
    lk, mlk, flag = gk.assembly10_flagged(*args)
    lk_p, mlk_p = gk.assembly10_plain(*args)
    torch.cuda.synchronize()
    if int(flag[0]) or not (torch.equal(lk, lk_p)
                            and torch.equal(mlk, mlk_p)):
        raise AssertionError(f"deep assembly10 differs at {(B, D)} (error "
                             f"word {int(flag[0])})")
    mid = int(((lk > 0) & (lk < 255)).any(dim=1).sum())
    print(f"  deep step B={B} D={D}: accumulate and assembly10 equal to "
          f"their plain versions, {int((k[2].sum(dim=1) > 255).sum())} "
          f"columns rescaled, {mid} with a likelihood strictly between 0 "
          "and 255", flush=True)
    lanes, taken = int(nk.sum()), int(k[2].sum())
    return {
        "accumulate": Case(
            err, lambda: gk.accumulate(s, nk, r, w, 60),
            lambda: gk.accumulate_plain(s, nk, r, w, 60),
            rank_bound(lanes, 4, B, 2, 14, taken)),
        "assembly10": Case(
            float((lk - lk_p).abs().max()), lambda: gk.assembly10(*args),
            lambda: gk.assembly10_plain(*args), assembly_bound(B, tables),
            launch=lambda: gk.assembly10_launch(*args)),
    }


def kernels_at_path_shapes(shapes: dict, dtabs, dev, torch,
                           floor_ms: float) -> dict:
    """Phase 8: every kernel against its plain version at every shape its
    path ran (random lanes), timed at the path's main shape (the first:
    the depth that carried the most columns); score_columns at each
    family's shapes (a u16 shape overwrites an equal u32 one: both
    score without dqstats), at the main shape also with joint priors
    (named ``score_columns/joint``).  ``shapes`` maps a family
    ("slab", "u32", "u16", or "deep": the slab step above D 255,
    deep_slab_cases) to its shapes.  Returns {(name, shape):
    (max_abs_err, ms, plain_ms, device_ms, plain_device_ms, bound_ms,
    bound_by) or (max_abs_err,)}."""
    family = {"slab": None, "u32": ("accumulate",), "u16": ("accumulate16",)}
    # rank_cases adds a rank kernel's fused kernel to depth 255
    out = {}
    for fam, fam_shapes in shapes.items():
        for i, (B, D) in enumerate(fam_shapes):
            if fam == "slab":
                cases = slab_cases(B, D, dtabs, dev, torch)
            elif fam == "deep":
                cases = deep_slab_cases(B, D, dtabs, dev, torch)
            else:
                cases = rank_cases(B, D, dtabs, dev, torch, family[fam])
            # the dqstats ride only on the slab's raw lanes
            dq = fam in ("slab", "deep")
            cases["score_columns"] = score_case(B, D, dev, torch, dq=dq)
            for name, case in cases.items():
                if i == 0:
                    out[name, (B, D)] = timed(name, (B, D), case, torch,
                                              floor_ms)
                else:
                    out[name, (B, D)] = (case.err,)
                    print(f"  {name:13s} B={B:5d} D={D:5d}  equal, "
                          f"max_abs_err={case.err:.3g}", flush=True)
            if i == 0:
                out["score_columns/joint", (B, D)] = score_joint(
                    B, D, dq, dev, torch, floor_ms)
    return out


def ensure_sim(name: str, sim: dict, index: bool) -> tuple[Path, int]:
    """A simulated pair in chip_smoke_data/<name>, optionally its BAM
    indexes, and its column count (tumor/normal pileup key intersection,
    the repo's bench definition).  Set-up, not timed."""
    import numpy as np

    from somatic_sniper_tpu_torch.io import bai, native_api
    from somatic_sniper_tpu_torch.utils.simulate import (SimConfig,
                                                         simulate_pair_fast)

    d = DATA / name
    meta = d / "columns.json"
    if not meta.exists():
        t0 = time.perf_counter()
        simulate_pair_fast(d, SimConfig(**sim))
        _, pu_t = native_api.load_and_columnize(str(d / "tumor.bam"))
        _, pu_n = native_api.load_and_columnize(str(d / "normal.bam"))
        n = len(np.intersect1d(pu_t.ukeys, pu_n.ukeys, assume_unique=True))
        meta.write_text(json.dumps({"columns": n, "sim": sim}))
        print(f"  generated {d.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if index:
        for bam in ("tumor.bam", "normal.bam"):
            bai.ensure_index(d / bam)
    return d, json.loads(meta.read_text())["columns"]


def load_u32_pair(pair: Path, dev):
    """The 10 Mb pair's pileups, prefilter flags and tables for the
    whole-file batch path (phases 6 and 11).  Returns (context tuple,
    seconds the load and the flags took)."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.io.bam import read_bam_header
    from somatic_sniper_tpu_torch.io.fasta import FastaFile
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables)
    from somatic_sniper_tpu_torch.pileup.prefilter import prefilter_tables

    params = ModelParams()
    tabs = build_tables(params)
    tumor, normal = str(pair / "tumor.bam"), str(pair / "normal.bam")
    fasta = FastaFile(str(pair / "ref.fa"))
    ref_blob, ref_off = runner._ref_blob(fasta, read_bam_header(tumor))
    gmin, margin = prefilter_tables(tabs)
    t0 = time.perf_counter()
    header_t, pu_t, _, pu_n = runner._load_pileups(
        tumor, normal, params, (ref_blob, ref_off, tabs.fk, gmin, margin))
    refcache = runner.RefCache(fasta, header_t)
    drop_t, drop_n = runner._prefilter_flags(pu_t, pu_n, ref_blob, ref_off,
                                             tabs)
    return ((params, tabs, pu_t, pu_n, refcache, drop_t, drop_n),
            time.perf_counter() - t0)


def u32_batches(loaded, t_load: float, n_cols: int, exact_lines: list[str],
                dev, torch, precision: str = "fast") -> tuple[dict, dict]:
    """The whole-file batch path with full-u32 batches on the 10 Mb pair
    (phase 6 in fast precision, phase 11 in exact, on the card either
    way).  Fast lines are held to the native exact output by the fast
    contract, exact lines byte for byte.  Returns (launches, stats) of
    the counted run."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.models.step_graph import STEP_GRAPHS
    from somatic_sniper_tpu_torch.models.tables import device_tables
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.utils.contract import diff_records, hist
    from somatic_sniper_tpu_torch.utils.stats import STATS

    params, tabs, pu_t, pu_n, refcache, drop_t, drop_n = loaded
    dtabs = device_tables(tabs, dev, precision)
    if dtabs.coef.device != dev:
        raise AssertionError(f"{precision} tables lie on {dtabs.coef.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    STATS.reset()
    gk.reset_launches()
    t1 = time.perf_counter()
    pending = runner.submit_batches(pu_t, pu_n, refcache, dtabs, dev,
                                    drop_t, drop_n, False, None,
                                    params.cap_mapq, precision=precision)
    recs = runner.collect_pending(pending, pu_t, pu_n, refcache, dtabs, dev,
                                  "vcf", precision=precision)
    t_score = time.perf_counter() - t1
    launches = dict(gk.LAUNCHES)
    stats = STATS.snapshot()
    print(f"  stage times of the {precision} batches:\n" + STATS.summary(),
          flush=True)
    lines = [ln.rstrip("\n") for _, ln in recs]
    want = [ln for ln in exact_lines if not ln.startswith("#")]
    batches = int(stats.get("batches_dispatched", 0))
    dev_cols = int(stats.get("device_columns", 0))
    wall = t_load + t_score
    print(f"  batches {batches}, device columns {dev_cols}, output lines "
          f"{len(lines)}", flush=True)
    if precision == "fast":
        print_digest(lines)
    print(f"  {precision}: wall {wall:.3f} s (load + prefilter {t_load:.3f} "
          f"s, batches {t_score:.3f} s), {n_cols / wall:.0f} cols/s of "
          f"{n_cols}; device columns {dev_cols / t_score:.0f} cols/s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
          "MiB", flush=True)
    print(f"  launches {launches}", flush=True)
    check_batch_routes(stats, f"{precision} batches",
                       STEP_GRAPHS.pool_bytes(dev) / 2**20, must_replay=True)
    if precision == "fast":
        tol = diff_records(lines, want, "vcf")
        print(f"  contract ok, hist {json.dumps(hist(tol), sort_keys=True)}",
              flush=True)
        check_batch_launches(launches, stats, "glfgen", "accumulate")
    else:
        if lines != want:
            raise AssertionError(
                f"exact batches on the card: {len(lines)} lines differ from "
                f"the native exact scorer's {len(want)}")
        print(f"  {len(lines)} lines byte-equal to the native exact "
              "output", flush=True)
        # the f64 glfgen is torch ops: the scoring after it is the one
        # hand-written kernel an exact batch launches
        others = {k: v for k, v in launches.items()
                  if v and k != "score_columns"}
        if (batches == 0 or dev_cols == 0 or others
                or launches["score_columns"] < batches):
            raise AssertionError(f"{batches} exact batches, {dev_cols} "
                                 f"device columns, launches {launches}")
    return launches, stats


def check_batch_launches(launches: dict, stats: dict, fused: str,
                         two_step: str) -> None:
    """A batch run's launch counts: two samples a batch; every batch to
    depth 255 through the fused kernel alone, and the stand-alone
    accumulate and assembly10 only for deeper batches (one each a
    sample), so that no batch to depth 255 waits on an error word; and
    score_columns at least once a batch (the overflow refetch scores a
    batch again)."""
    batches = int(stats.get("batches_dispatched", 0))
    deep = any(D > 255 for _, D in
               path_shapes(stats, "batch_columns_at_depth_", lambda n: n))
    others = {k: v for k, v in launches.items()
              if v and k not in (fused, two_step, "assembly10",
                                 "score_columns")}
    if (batches == 0 or others or launches[fused] == 0
            or launches["score_columns"] < batches
            or launches[fused] + launches[two_step] < 2 * batches
            or launches["assembly10"] != launches[two_step]
            or (launches[two_step] > 0) != deep):
        raise AssertionError(
            f"{batches} batches (deeper than 255 among them: {deep}) "
            f"launched {launches}")


BATCH_ROUTES = ("batches_dispatched", "batches_graphed", "batch_captures",
                "batches_eager_first", "batches_eager_cpu")
# the eager route of earlier builds: it may not run on a card any more
RETIRED_ROUTES = ("batches_eager_deep",)


def batch_keys(stats: dict) -> dict:
    """{(encoding, precision, B, D): batches} of the keys a batch run
    sent through the captured step's route (its ``batch_key_*``
    counters, runner.submit_call_batch)."""
    out = {}
    for k, v in stats.items():
        if k.startswith("batch_key_"):
            enc, precision, shape = k[len("batch_key_"):].split("_")
            B, D = shape.split("x")
            out[enc, precision, int(B), int(D)] = int(v)
    return out


def check_batch_routes(stats: dict, what: str, pool_mib: float,
                       must_replay: bool) -> None:
    """A batch run's routes on the card: every batch dispatched is a
    key's first (eager) or a replay of its key's captured step, at
    every depth (a fast batch deeper than 255 included); one capture
    for each key that came twice; no CPU route and no retired eager
    route.  With ``must_replay``, at least one key replayed."""
    routes = {k: int(stats.get(k, 0)) for k in BATCH_ROUTES}
    keys = batch_keys(stats)
    print(f"  {what}: routes {json.dumps(routes)}; {len(keys)} keys "
          "(encoding, precision, B, D: batches) " + ", ".join(
              f"{e} {p} {B}x{D}: {n}" for (e, p, B, D), n in
              sorted(keys.items())) + f"; the graph pool holds "
          f"{pool_mib:.1f} MiB", flush=True)
    retired = {k: stats[k] for k in RETIRED_ROUTES if stats.get(k)}
    if (routes["batches_dispatched"] != routes["batches_eager_first"]
            + routes["batches_graphed"]
            or routes["batches_eager_first"] != len(keys)
            or routes["batch_captures"] != sum(n >= 2 for n in keys.values())
            or routes["batches_eager_cpu"] or retired
            or (must_replay and routes["batches_graphed"] == 0)):
        raise AssertionError(f"{what}: routes {routes}, keys {keys}, "
                             f"retired routes {retired}")


NO_NATIVE_CHILD = """\
import json, sys
sys.modules["jax"] = None
sys.modules["somatic_sniper_tpu"] = None
from somatic_sniper_tpu_torch.cli.main import main
from somatic_sniper_tpu_torch.io import native_api
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
from somatic_sniper_tpu_torch.utils.stats import STATS
if native_api.available():
    sys.exit("the native library loaded")
STATS.reset()
gk.reset_launches()
rc = main(sys.argv[1:])
from somatic_sniper_tpu_torch.models.step_graph import STEP_GRAPHS
print(STATS.summary())
print(json.dumps({"launches": gk.LAUNCHES, "stats": STATS.snapshot(),
                  "pool_mib": STEP_GRAPHS.pool_bytes("cuda") / 2**20}))
sys.exit(rc)
"""


def cli_without_native(out_dir: Path, torch) -> tuple[dict, dict]:
    """Phase 7: the whole-file CLI with the native library missing on a
    1 Mb pair, in a child process; held to the port's native exact
    output.  Returns (launches, stats) of the child's run."""
    from somatic_sniper_tpu_torch.utils.contract import diff_records, hist

    pair, n_cols = ensure_sim("pair_1mb", SIM_1MB, index=False)
    common = ["-F", "vcf", "-f", str(pair / "ref.fa"),
              str(pair / "tumor.bam"), str(pair / "normal.bam")]
    exact_wall = run_cli(["--precision", "exact", "--device", "cuda",
                          *common, str(out_dir / "1mb_exact.vcf")])
    out = out_dir / "1mb_fast_no_native.vcf"
    env = dict(os.environ,
               SNIPER_NATIVE_LIB=str(DATA / "no_such_native_library.so"))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", NO_NATIVE_CHILD, "--precision", "fast",
         "--device", "cuda", *common, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"no-native CLI exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    *summary, last = r.stdout.strip().splitlines()
    child = json.loads(last)
    print("  stage times of the child's run:\n" + "\n".join(summary),
          flush=True)
    launches, stats = child["launches"], child["stats"]
    tol = diff_records(body_lines(out), body_lines(out_dir / "1mb_exact.vcf"),
                       "vcf")
    print(f"  columns {n_cols}, output lines {len(body_lines(out))}, "
          f"batches {int(stats.get('batches_dispatched', 0))}, device "
          f"columns {int(stats.get('device_columns', 0))}", flush=True)
    print_digest(body_lines(out))
    print(f"  fast without native: wall {wall:.3f} s (child process, "
          f"decode {stats.get('decode', 0):.3f} s), {n_cols / wall:.0f} "
          f"cols/s; native exact wall {exact_wall:.3f} s", flush=True)
    print(f"  launches {launches}", flush=True)
    print(f"  contract ok, hist {json.dumps(hist(tol), sort_keys=True)}",
          flush=True)
    check_batch_launches(launches, stats, "glfgen16", "accumulate16")
    check_batch_routes(stats, "u16 batches (child)", child["pool_mib"],
                       must_replay=False)
    return launches, stats


CLI_CHILD = """\
import sys
sys.modules["jax"] = None
sys.modules["somatic_sniper_tpu"] = None
from somatic_sniper_tpu_torch.cli.main import main
sys.exit(main(sys.argv[1:]))
"""


def parse_summaries(err: str) -> list[dict]:
    """The stage summaries (``utils/stats.RunStats.summary``) in a run's
    standard error, one dict a summary: seconds of a timed stage, the
    count of a counter."""
    blocks, inside = [], False
    for ln in err.splitlines():
        if ln.startswith("[sniper-tpu stats]"):
            blocks.append({})
            inside = True
        elif inside and ln.startswith("  ") and len(ln.split()) >= 2:
            name, val = ln.split()[:2]
            try:
                blocks[-1][name] = (float(val[:-1]) if val.endswith("s")
                                    else int(val))
            except ValueError:
                inside = False
        else:
            inside = False
    return blocks


def start_cli(args: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", CLI_CHILD, *args], cwd=REPO,
        env=dict(os.environ, SNIPER_STATS="1", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cli(procs: list[subprocess.Popen], limit: float) -> list[str]:
    """Wait for the child processes (killed at the limit); returns what
    each wrote to its standard error, raising if one failed."""
    deadline = time.monotonic() + limit
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise AssertionError(f"CLI child exited {p.returncode}:\n"
                                 f"{err[-4000:]}")
    return errs


def check_scored_on_card(summaries: list[dict], n: int, what: str) -> dict:
    """``n`` processes' summaries, each of which must show slabs scored
    through glfgen32 on the card (one launch a sample a slab) and its
    region loads inflated and built there (``check_card_load``).  Returns
    the launches of the path, summed."""
    if len(summaries) != n:
        raise AssertionError(f"{what}: {len(summaries)} stage summaries "
                             f"for {n} processes")
    for i, b in enumerate(summaries):
        if (b.get("launches_glfgen32", 0) <= 0
                or b["launches_glfgen32"] != 2 * b.get("slabs_dispatched", 0)
                or b.get("slabs_graphed", 0) != b["slabs_dispatched"]
                or b.get("device_columns", 0) <= 0):
            raise AssertionError(
                f"{what}: process {i} did not score its slabs through "
                f"glfgen32 in the captured step on the card: {b}")
    loads = [check_card_load(b, f"{what} process {i}")
             for i, b in enumerate(summaries)]
    return {"glfgen32": sum(b["launches_glfgen32"] for b in summaries),
            **{k: sum(x[k] for x in loads) for k in loads[0]}}


def jobs_runs(common: list[str], out_dir: Path, fast_lines: list[str],
              n_cols: int, inproc_walls: list[float]) -> dict:
    """Phase 9: ``--jobs 1, 2, 4`` through the CLI, each run a child
    process, fast on the card.  Returns {jobs: launches of its
    workers}."""
    ncpu = os.cpu_count() or 1
    print(f"  host cores {ncpu}; single process inside this process "
          "(phase 4, torch loaded, context up): " + ", ".join(
              f"{w:.3f} s" for w in inproc_walls), flush=True)
    launches = {}
    for jobs in (1, 2, 4):
        out = out_dir / f"jobs{jobs}.vcf"
        t0 = time.perf_counter()
        # the spawn time lets the parent report its own imports; it
        # stamps a new one for its workers
        err, = finish_cli([start_cli(
            ["--precision", "fast", "--device", "cuda", "--jobs", str(jobs),
             *common, str(out)],
            {"SNIPER_JOBS_SPAWNED_AT": repr(time.time())})], 600)
        wall = time.perf_counter() - t0
        if body_lines(out) != fast_lines:
            raise AssertionError(f"--jobs {jobs} gave other bytes than the "
                                 "single process")
        workers = parse_summaries(err)
        # --jobs N > 1: the parent, which scores nothing, reports too
        parents = [b for b in workers if "jobs_workers" in b]
        workers = [b for b in workers if "jobs_workers" not in b]
        launches[jobs] = check_scored_on_card(workers, min(jobs, ncpu),
                                              f"--jobs {jobs}")
        print(f"  --jobs {jobs}: wall {wall:.3f} s ({n_cols / wall:.0f} "
              f"cols/s), bytes equal to phase 4's fast output; glfgen32 "
              f"launches {[b['launches_glfgen32'] for b in workers]}",
              flush=True)
        for b in parents:
            print(f"    parent: the interpreter and the imports "
                  f"{b.get('worker_startup.imports', 0):.3f} s (no torch), "
                  f"both builds {b.get('jobs.build', 0):.3f} s, waiting for "
                  f"its workers {b.get('jobs.workers', 0):.3f} s", flush=True)
        if jobs > 1 and len(parents) != 1:
            raise AssertionError(f"--jobs {jobs}: {len(parents)} parent "
                                 "summaries")
        for i, b in enumerate(workers):
            if jobs > 1 and "worker_startup" not in b:
                raise AssertionError(f"worker {i} reported no start-up")
            start = (f"start-up (spawn to first window) "
                     f"{b['worker_startup']:.3f} s, of which the "
                     f"interpreter and the imports "
                     f"{b.get('worker_startup.imports', 0):.3f} s, "
                     if jobs > 1 else "")
            print(f"    process {i}: {start}load_wait "
                  f"{b.get('load_wait', 0):.3f} s, plan "
                  f"{b.get('plan', 0):.3f} s, pad+dispatch "
                  f"{b.get('pad+dispatch', 0):.3f} s, device "
                  f"{b.get('device', 0):.3f} s, emit {b.get('emit', 0):.3f} "
                  f"s, tail {b.get('tail', 0):.3f} s; device columns "
                  f"{b.get('device_columns', 0)}, slabs "
                  f"{b.get('slabs_dispatched', 0)}",
                  flush=True)
    return launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def collective_runs(common: list[str], out_dir: Path, fast_lines: list[str],
                    n_cols: int) -> dict:
    """Phase 10: two processes joined through a local coordinator, both
    scoring on the one card, ``--merge collective``; once at the default
    chunk and once at 4096 bytes (many rounds).  Returns the launches of
    the first run's two processes."""
    launches = None
    for chunk in (None, "4096"):
        out = out_dir / f"collective_{chunk or 'default'}.vcf"
        for f in out_dir.glob(out.name + "*"):
            f.unlink()
        env = {"SNIPER_COORDINATOR": f"127.0.0.1:{free_port()}",
               "SNIPER_NUM_PROCESSES": "2"}
        if chunk:
            env["SNIPER_MERGE_CHUNK"] = chunk
        t0 = time.perf_counter()
        errs = finish_cli([start_cli(
            ["--precision", "fast", "--device", "cuda", "--merge",
             "collective", *common, str(out)],
            dict(env, SNIPER_PROCESS_ID=str(i))) for i in range(2)], 600)
        wall = time.perf_counter() - t0
        if body_lines(out) != fast_lines:
            raise AssertionError("the collective merge gave other bytes "
                                 "than the single process")
        shard_bytes = [(out_dir / f"{out.name}.shard{i}").stat().st_size
                       for i in range(2)]
        procs = [b for err in errs for b in parse_summaries(err)]
        counted = check_scored_on_card(procs, 2, "--merge collective")
        launches = launches or counted
        rounds = max(1, -(-max(shard_bytes) // int(chunk or 4 << 20)))
        print(f"  chunk {chunk or 'default (4 MiB)'}: wall {wall:.3f} s "
              f"({n_cols / wall:.0f} cols/s), merged bytes equal to phase "
              f"4's fast output; shards {shard_bytes} bytes, {rounds} "
              f"round(s); glfgen32 launches "
              f"{[b['launches_glfgen32'] for b in procs]}", flush=True)
    return launches


def exact_golden_without_native(out_dir: Path) -> None:
    """Phase 11, second half: the golden pair through the CLI with the
    native library missing, exact precision on the card."""
    out = out_dir / "golden_exact_no_native.vcf"
    t0 = time.perf_counter()
    err, = finish_cli([start_cli(
        ["--precision", "exact", "--device", "cuda", "-F", "vcf", "-f",
         str(GOLDEN / "small.fa"), str(GOLDEN / "t-small.bam"),
         str(GOLDEN / "n-small.bam"), str(out)],
        {"SNIPER_NATIVE_LIB": str(DATA / "no_such_native_library.so")})],
        600)
    b, = parse_summaries(err)
    if b.get("batches_dispatched", 0) <= 0 or "decode" not in b:
        raise AssertionError(f"the run did not take the batch path: {b}")
    if body_lines(out) != body_lines(GOLDEN / "expected.vcf"):
        raise AssertionError("exact without the native library differs "
                             "from tests/data/expected.vcf")
    print(f"  golden pair, exact on the card without the native library: "
          f"{len(body_lines(out))} lines equal to tests/data/expected.vcf, "
          f"{b['batches_dispatched']} batches, {b['device_columns']} device "
          f"columns, wall {time.perf_counter() - t0:.3f} s (child process)",
          flush=True)


# fields that pass through the f32 class sums: the kernel and its plain
# version add them in another order, so these may differ by one
# quantisation step (the fast contract); every other field must be equal
PM1_FIELDS = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
              "somatic_score", "joint_cnsq")


def step_diff(got, want, torch) -> dict:
    """Histogram ``{field+-delta: columns}`` of a CallResult against
    another; raises on any difference outside the fast contract."""
    hist = {}
    for name, a, b in zip(got._fields, got, want):
        if a is None and b is None:  # dqstats of other lanes, error word
            continue
        diff = (a.to(torch.int64) - b.to(torch.int64)).flatten()
        for d in diff[diff != 0].tolist():
            hist[f"{name}{d:+d}"] = hist.get(f"{name}{d:+d}", 0) + 1
            if name not in PM1_FIELDS or abs(d) > 1:
                raise AssertionError(f"{name} differs by {d}")
    return hist


def bench_plain_scoring(B: int, D: int):
    """``utils.mfu.bench_kernel`` with ``score_columns_plain`` in the
    kernel's place, in a registry of captured steps of its own: the
    scoring step before score_columns (glfgen32, then the torch ops of
    consensus, score, gates and dqstats), measured in this call on this
    card."""
    from somatic_sniper_tpu_torch.models import somatic as ms
    from somatic_sniper_tpu_torch.models import step_graph as sg
    from somatic_sniper_tpu_torch.ops import score_kernels as sk
    from somatic_sniper_tpu_torch.utils import mfu

    saved = sg.STEP_GRAPHS, ms.score_columns
    sg.STEP_GRAPHS, ms.score_columns = sg.SlabStepGraph(), \
        sk.score_columns_plain
    try:
        return mfu.bench_kernel(B=B, D=D, iters=16)
    finally:
        sg.STEP_GRAPHS, ms.score_columns = saved


def bench_kernel_on_card(dev, torch) -> None:
    """Phase 13: the scoring step's microbenchmark on the card, the
    step through score_columns (twice, for the spread) beside the same
    step through its plain version (the step before the kernel) in
    between."""
    import numpy as np

    from somatic_sniper_tpu_torch.models import glfgen as mg
    from somatic_sniper_tpu_torch.models import somatic as ms
    from somatic_sniper_tpu_torch.models.somatic import (
        call_batch, call_batch_packed, packed_column_batches)
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.ops import score_kernels as sk
    from somatic_sniper_tpu_torch.utils import mfu

    params = ModelParams()
    dtabs = device_tables(build_tables(params), dev, "fast")
    for B, D in ((8192, 48), (32768, 64)):
        gk.reset_launches()
        r = mfu.bench_kernel(B=B, D=D, iters=16)
        others = {k: v for k, v in gk.LAUNCHES.items()
                  if v and k not in ("glfgen32", "score_columns")}
        if (r.steps_run < 40 or gk.LAUNCHES["glfgen32"] != 2 * r.steps_run
                or gk.LAUNCHES["score_columns"] != r.steps_run or others
                or r.kernel_launches != {"glfgen32": 2, "score_columns": 1}):
            raise AssertionError(
                f"bench_kernel at {(B, D)}: {r.steps_run} steps launched "
                f"{gk.LAUNCHES}, a step {r.kernel_launches}")
        if B == 8192 and r.launches_per_step >= 40:
            raise AssertionError(f"the eager slab step queues "
                                 f"{r.launches_per_step} device operations")
        plain = bench_plain_scoring(B, D)
        again = mfu.bench_kernel(B=B, D=D, iters=16)
        print(f"  B={B} D={D} scoring step, kernel against its plain "
              f"version in this call: device operations a step "
              f"{r.launches_per_step} against {plain.launches_per_step} "
              f"(torch-op step recorded {TORCH_OP_STEP['slab_ops']} at "
              f"(8192, 48)); "
              f"graphed step {r.measured_slab_s * 1e3:.4f} ms, again "
              f"{again.measured_slab_s * 1e3:.4f} ms, against "
              f"{plain.measured_slab_s * 1e3:.4f} ms (torch-op step recorded "
              f"{TORCH_OP_STEP['slab_replay_ms']} ms at (8192, 48)); eager "
              f"step {r.eager_slab_s * 1e3:.4f} / "
              f"{again.eager_slab_s * 1e3:.4f} ms against "
              f"{plain.eager_slab_s * 1e3:.4f} ms; a slab's whole call "
              f"{r.graph_run_s * 1e3:.4f} / {again.graph_run_s * 1e3:.4f} ms "
              f"against {plain.graph_run_s * 1e3:.4f} ms", flush=True)
        stacked_h, meta_h = mfu.bench_inputs(B, D)
        stacked = torch.from_numpy(stacked_h.view(np.int32)).to(dev)
        meta = torch.from_numpy(meta_h).to(dev)
        cbs = packed_column_batches(stacked, meta)
        got = (call_batch_packed(stacked, meta, dtabs, params),
               call_batch(*cbs, dtabs, params))
        kernels = mg.glfgen32, ms.score_columns
        mg.glfgen32, ms.score_columns = (gk.glfgen32_plain,
                                         sk.score_columns_plain)
        try:
            want = (call_batch_packed(stacked, meta, dtabs, params),
                    call_batch(*cbs, dtabs, params))
        finally:
            mg.glfgen32, ms.score_columns = kernels
        torch.cuda.synchronize()
        # the benchmark's tumor and normal differ in one baseQ bit, so
        # few sites or none emit: hold the emitted rows, then every
        # column's full result
        count = int(got[0].count)
        if (count != int(want[0].count)
                or not torch.equal(got[0].rows[:count], want[0].rows[:count])):
            raise AssertionError(f"one step at {(B, D)}: the rows through "
                                 "the kernel differ from the plain versions'")
        hist = step_diff(got[1], want[1], torch)
        print(f"  B={B} D={D}: graphed step {r.measured_slab_s * 1e3:.4f} "
              f"ms (the host queues one in {r.host_queue_s * 1e3:.4f} ms), "
              f"eager step {r.eager_slab_s * 1e3:.4f} ms (queued in "
              f"{r.eager_host_queue_s * 1e3:.4f} ms), a slab's whole call "
              f"(upload, replay, fetch, one wait) "
              f"{r.graph_run_s * 1e3:.4f} ms; "
              f"{r.cols_per_sec:.0f} pair-columns/s graphed; FLOPs a "
              f"pair-column {r.port_flops_per_col:.0f} by the port's count "
              f"({r.flops_per_col:.0f} by the JAX package's), "
              f"{r.tflops:.5f} TFLOP/s, est_mfu {r.est_mfu:.6f} of the f32 "
              f"peak; bounds: f32 {r.bound_compute_s * 1e3:.5f} ms, bytes "
              f"{r.bound_hbm_s * 1e3:.5f} ms, launches "
              f"{r.bound_launch_s * 1e3:.4f} ms ({r.launches_per_step} "
              f"device operations a step, glfgen32 twice and score_columns "
              f"once among them, at "
              f"{r.launch_floor_s * 1e6:.2f} us an empty launch replayed "
              f"from a graph; queued on a stream, as the eager step's are, "
              f"{r.stream_launch_floor_s * 1e6:.2f} us, a launch bound of "
              f"{r.launches_per_step * r.stream_launch_floor_s * 1e3:.4f} "
              f"ms); {count} "
              f"emitted rows equal to the plain versions', the "
              f"{len(got[1])} fields of {B} columns inside the fast "
              f"contract, hist {json.dumps(hist, sort_keys=True)}; verdict: "
              f"{r.verdict}", flush=True)


def check_graphed(stats: dict, what: str) -> None:
    """Every slab of a run on the card went through the captured step."""
    slabs = int(stats.get("slabs_dispatched", 0))
    if int(stats.get("slabs_graphed", 0)) != slabs:
        raise AssertionError(f"{what}: {stats.get('slabs_graphed', 0)} of "
                             f"{slabs} slabs replayed the captured step")


def random_packed_slab(B: int, D: int, seed: int):
    """A two-sample slab in the layout of ``io.native_api
    .slab_fill_pair``: (stacked uint32 [2, B, D], meta int32 [3, B]),
    the raw depth one more than the kept lanes where any are kept, to
    D; depths and kept counts in bytes to D = 255, in 16-bit halves of
    meta[1] and meta[2] deeper."""
    import numpy as np

    s_t, nk_t, ref16 = random_slab_lanes(B, D, seed)
    s_n, nk_n, _ = random_slab_lanes(B, D, seed + 1000)
    d_t = np.minimum(nk_t + (nk_t > 0), D).astype(np.uint32)
    d_n = np.minimum(nk_n + (nk_n > 0), D).astype(np.uint32)
    nk_t, nk_n = nk_t.astype(np.uint32), nk_n.astype(np.uint32)
    meta = np.zeros((3, B), np.uint32)
    meta[0] = ref16.astype(np.uint32) << 24
    if D <= 255:
        meta[2] = d_t | d_n << 8 | nk_t << 16 | nk_n << 24
    else:
        meta[1] = d_t | d_n << 16
        meta[2] = nk_t | nk_n << 16
    return (np.stack([s_t, s_n]).view(np.uint32), meta.view(np.int32))


def slab_step_launches(D: int) -> dict:
    """The kernel launches of one slab step at depth D: the fused
    glfgen32 a sample to 255; deeper, the accumulate and assembly10 a
    sample (the c_tot > 255 rescale between them); score_columns once."""
    if D <= 255:
        return {"glfgen32": 2, "score_columns": 1}
    return {"accumulate": 2, "assembly10": 2, "score_columns": 1}


def graphed_against_eager(dev, torch, B: int = 8192,
                          depths=None) -> None:
    """Phase 17: the captured step against the eager step at every slab
    depth (``depths``, by default ``ALLOWED_D``), both priors, two input
    sets back to back, B columns a slab; each key's device operations an
    eager step and its replay ms."""
    from somatic_sniper_tpu_torch.models.somatic import call_batch_packed
    from somatic_sniper_tpu_torch.models.step_graph import STEP_GRAPHS
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.parallel.slab import ALLOWED_D
    from somatic_sniper_tpu_torch.utils.mfu import count_step_ops

    for joint in (False, True):
        params = ModelParams(use_joint_priors=joint, min_somatic_qual=0)
        dtabs = device_tables(build_tables(params), dev, "fast")
        for D in depths or ALLOWED_D:
            known = set(STEP_GRAPHS.captures())
            emitted = []
            for seed in (D, D + 1):
                stacked_h, meta_h = random_packed_slab(B, D, seed)
                gk.reset_launches()
                res = call_batch_packed(
                    torch.from_numpy(stacked_h.view("int32")).to(dev),
                    torch.from_numpy(meta_h).to(dev), dtabs, params)
                n_e = int(res.count)
                rows_e = res.rows[:n_e].cpu().numpy()
                eager = dict(gk.LAUNCHES)
                gk.reset_launches()
                n, rows = STEP_GRAPHS.run(stacked_h, meta_h, dtabs, params,
                                          dev)
                if (dict(gk.LAUNCHES) != eager
                        or {k: v for k, v in eager.items() if v}
                        != slab_step_launches(D)):
                    raise AssertionError(
                        f"launches: eager {eager}, graphed {gk.LAUNCHES}")
                if (n != n_e or rows.tobytes() != rows_e.tobytes()
                        or n == 0):
                    raise AssertionError(
                        f"the captured step differs from the eager one at "
                        f"{(B, D)}, joint {joint}, seed {seed}: {n} rows "
                        f"against {n_e}")
                emitted.append(n)
            new = {k: v for k, v in STEP_GRAPHS.captures().items()
                   if k not in known}
            if len(new) != 1:
                raise AssertionError(f"{len(new)} captures for one shape")
            s = torch.from_numpy(stacked_h.view("int32")).to(dev)
            m = torch.from_numpy(meta_h).to(dev)
            ops = count_step_ops(
                lambda: call_batch_packed(s, m, dtabs, params)) + sum(
                    eager.values())
            replay_ms, replay_q = step_times(
                STEP_GRAPHS.step(B, D, dtabs, params, dev).replay, torch)
            print(f"  B={B} D={D:3d} joint={joint!s:5s}: captured in "
                  f"{1e3 * next(iter(new.values())):.1f} ms (two eager "
                  f"warm-up steps included); two input sets, {emitted} "
                  "rows, count and rows byte-equal to the eager step, "
                  f"launches {slab_step_launches(D)} each way; "
                  f"{ops} device operations an eager step, replay "
                  f"{replay_ms:.4f} ms (queued in {replay_q:.4f}); "
                  f"torch-op step "
                  f"recorded {TORCH_OP_STEP['slab_ops']} operations and "
                  f"{TORCH_OP_STEP['slab_replay_ms']} ms at D = 48",
                  flush=True)
    caps = STEP_GRAPHS.captures()
    print(f"  {len(caps)} captured steps in this process, the graph pool "
          f"holds {STEP_GRAPHS.pool_bytes(dev) / 2**20:.1f} MiB of device "
          f"memory; captures of the other phases: " + ", ".join(
              f"{'slab' if k[5].packed16 is None else 'batch'} B={k[1]} "
              f"D={k[2]} joint={k[3].use_joint_priors} {k[5].precision} "
              f"{1e3 * v:.1f} ms" for k, v in caps.items()
              if k[3].min_somatic_qual != 0), flush=True)


def batch_upload(B: int, D: int, seed: int, packed16: bool):
    """A random two-sample batch in the batch path's upload layout
    (runner.submit_call_batch): (stacked [2, B, D] int32 slot words or
    uint16 lanes, meta int32 [3, B] or [7, B])."""
    import numpy as np

    s_t, d_t, ref16 = random_u32_lanes(B, D, seed)
    s_n, d_n, _ = random_u32_lanes(B, D, seed + 1000)
    if not packed16:
        return np.stack([s_t, s_n]), np.stack([d_t, d_n, ref16])
    rows = [d_t, d_n, ref16]
    lanes = []
    for s, d in ((s_t, d_t), (s_n, d_n)):
        t16, nk = packed16_lanes(s, d, ref16)
        lanes.append(t16)
        rows.append(nk)
    for s, d in ((s_t, d_t), (s_n, d_n)):
        w = s.view(np.uint32)
        keep = ((np.arange(D)[None, :] < d[:, None])
                & (((w >> 21) & 1) == 0))
        m7 = np.minimum(w & 0x7F, 60).astype(np.int64)
        rows.append(np.where(keep, m7 * m7, 0).sum(axis=1))
    return np.stack(lanes), np.stack(rows).astype(np.int32)


def step_times(fn, torch, reps: int = 5) -> tuple[float, float]:
    """(ms a call on the stream, host ms to queue a call): ``reps``
    calls back to back between two CUDA events after a warm call; the
    host clock around the queueing."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - h0
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps, 1e3 * host_s / reps


def graphed_batches_against_eager(keys, dev, torch) -> None:
    """Phase 18: every (encoding, precision, B, D) key the batch runs of
    phases 6, 7 and 11 sent through the captured step, in a registry of
    its own: two random input sets, the first batch eager, the same set
    captured and replayed, the second set replayed, each count and rows
    byte-equal to the eager step on its inputs with the same launches;
    the capture's ms, the eager and graphed step's ms on the stream and
    the host's ms to queue each, and the pool's MiB."""
    from somatic_sniper_tpu_torch.models.step_graph import (SlabStepGraph,
                                                            StepSpec)
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.runner import MAX_EMIT
    from somatic_sniper_tpu_torch.utils.mfu import count_step_ops

    t0 = time.perf_counter()
    params = ModelParams()
    tabs = build_tables(params)
    graphs = SlabStepGraph()
    for enc, precision, B, D in sorted(keys):
        packed16 = enc == "u16"
        spec = StepSpec(packed16, precision, min(MAX_EMIT, B))
        dtabs = device_tables(tabs, dev, precision)
        sets = [batch_upload(B, D, seed, packed16) for seed in (D, D + 1)]
        on_card = [tuple(torch.from_numpy(a).to(dev) for a in st)
                   for st in sets]
        eager = []
        for s, m in on_card:
            gk.reset_launches()
            res = spec.score(s, m, dtabs, params)
            n = int(res.count)
            eager.append((n, res.rows[:n].cpu().numpy().tobytes(),
                          dict(gk.LAUNCHES)))
        for i, want in ((0, "first"), (0, "capture"), (1, "replay")):
            gk.reset_launches()
            route, res = graphs.run_batch(*sets[i], dtabs, params, spec,
                                          dev)
            n = int(res.count)
            got = (n, res.rows[:n].cpu().numpy().tobytes(),
                   dict(gk.LAUNCHES))
            if route != want or got != eager[i]:
                raise AssertionError(
                    f"{enc} {precision} {(B, D)}, set {i}: route {route} "
                    f"(expected {want}), {n} rows against {eager[i][0]}, "
                    f"launches {got[2]} against {eager[i][2]}")
        key = graphs.key(dev, B, D, params, dtabs, spec)
        step = graphs.step(B, D, dtabs, params, dev, spec)
        s, m = on_card[1]
        eager_ms, eager_q = step_times(
            lambda: spec.score(s, m, dtabs, params), torch)
        graphed_ms, graphed_q = step_times(step.replay, torch)
        ops = (count_step_ops(lambda: spec.score(s, m, dtabs, params))
               + sum(eager[1][2].values()))
        print(f"  {enc} {precision:5s} B={B:5d} D={D:4d}: count and rows "
              f"byte-equal to the eager step on two input sets ({eager[0][0]}"
              f", {eager[1][0]} rows), launches "
              f"{ {k: v for k, v in eager[0][2].items() if v} }; "
              f"capture {1e3 * graphs.captures()[key]:.1f} ms; eager "
              f"{eager_ms:.3f} ms (queued in {eager_q:.3f}), graphed "
              f"{graphed_ms:.3f} ms (queued in {graphed_q:.3f}); {ops} "
              f"device operations an eager step; torch-op step recorded "
              f"replays "
              f"{TORCH_OP_STEP['batch_replay_ms_' + precision]} ms; pool "
              f"{graphs.pool_bytes(dev) / 2**20:.1f} MiB", flush=True)
    print(f"  {len(graphs.captures())} captured batch steps, their pool "
          f"{graphs.pool_bytes(dev) / 2**20:.1f} MiB; phase 18 took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def deep_error_word(dev, torch) -> None:
    """Phase 18, the error word of a fast batch deeper than 255: three
    batches of one (4096, 300) key through ``runner.submit_call_batch``
    (first eager, then captured, then replayed) with a device tensor
    added to the rescaled class counts, set outside the tables before
    the replay: the replay sets its error word, nothing raises at
    submit, and ``collect_pending`` raises the stand-alone
    ``assembly10``'s ValueError."""
    import numpy as np

    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.models import glfgen as mg
    from somatic_sniper_tpu_torch.models import step_graph as sg
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch

    dtabs = device_tables(build_tables(ModelParams()), dev)
    bad = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    saved, real = sg.STEP_GRAPHS, mg.rescale_counts
    sg.STEP_GRAPHS = sg.SlabStepGraph()
    mg.rescale_counts = lambda c: real(c) + bad
    try:
        pending = []
        for seed in (1, 2, 3):
            stacked, meta = batch_upload(4096, 300, seed, False)
            batch = PairedBatch(
                keys=np.arange(4096, dtype=np.int64), ref16=meta[2],
                tumor=stacked[0], normal=stacked[1], n_tumor=meta[0],
                n_normal=meta[1])
            if seed == 3:
                bad[0, 1] = 1000
            pending.append((batch, meta[2], runner.submit_call_batch(
                batch, meta[2], dtabs, dev)))
        errs = [int(p[2].err) for p in pending]
        if errs != [0, 0, 1] or len(sg.STEP_GRAPHS.captures()) != 1:
            raise AssertionError(f"error words {errs}, captures "
                                 f"{len(sg.STEP_GRAPHS.captures())}")
        try:
            runner.collect_pending(pending, None, None, None, dtabs, dev)
        except ValueError as e:
            if str(e) != gk._count_error(256):
                raise
            message = str(e)
        else:
            raise AssertionError("an out-of-table count passed collect")
    finally:
        sg.STEP_GRAPHS, mg.rescale_counts = saved, real
    torch.cuda.synchronize()
    print(f"  fast (4096, 300): a count pushed outside the tables before "
          f"the key's replay set its error word (words {errs}), no submit "
          f"raised, collect_pending raised ValueError: {message}",
          flush=True)


def entry_on_card(torch) -> None:
    """Phase 14: the forward step of ``entry()`` on the card against
    ``entry("cpu")``."""
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.parallel.dryrun import entry

    fn, args = entry()
    if args[0].slots.device.type != "cuda":
        raise AssertionError(f"entry() put its batches on "
                             f"{args[0].slots.device}")
    gk.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    if (gk.LAUNCHES["glfgen"] != 2 or gk.LAUNCHES["score_columns"] != 1
            or sum(gk.LAUNCHES.values()) != 3):
        raise AssertionError(f"entry()'s step launched {gk.LAUNCHES}")
    fn_cpu, args_cpu = entry("cpu")
    want = fn_cpu(*args_cpu)
    hist = {}
    for name, a, b in zip(got._fields, got, want):
        if a is None and b is None:
            continue
        diff = (a.cpu().to(torch.int64) - b.to(torch.int64)).flatten()
        for d in diff[diff != 0].tolist():
            hist[f"{name}{d:+d}"] = hist.get(f"{name}{d:+d}", 0) + 1
    if hist:
        raise AssertionError("entry() on the card differs from entry('cpu')"
                             f": {json.dumps(hist, sort_keys=True)}")
    print(f"  entry(): fn(*args) on {args[0].slots.device} launched glfgen "
          f"twice and score_columns once; all {len(got._fields)} fields of "
          f"{got.emit.shape[0]} columns equal to entry('cpu')'s, "
          f"{int(got.emit.sum())} emitted", flush=True)


def records_and_prefilter(pair: Path, out_dir: Path, fast_lines: list[str],
                          n_cols: int, dev) -> dict:
    """Phase 15: the windowed driver's record objects, then the run with
    the prefilter off, both on the 10 Mb pair, fast on the card, both
    held to phase 4's fast output byte for byte.  Returns the launches
    of the prefilter-off run."""
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.output.formatters import get_formatter
    from somatic_sniper_tpu_torch.output.records import (HeaderData,
                                                         SniperRecord)
    from somatic_sniper_tpu_torch.parallel.sharded import call_pair_windows
    from somatic_sniper_tpu_torch.utils.stats import STATS

    args = (str(pair / "tumor.bam"), str(pair / "normal.bam"),
            str(pair / "ref.fa"))
    header_fn, record_fn = get_formatter("vcf")
    hdata = HeaderData(refseq=args[2], normal_sample_id="NORMAL",
                       tumor_sample_id="TUMOR")
    launches = {}
    for what, kw in (("fmt=None", dict(fmt=None)),
                     ("prefilter=False", dict(fmt="vcf", prefilter=False))):
        out = out_dir / f"windows_{what.split('=')[0]}.vcf"
        STATS.reset()
        gk.reset_launches()
        t0 = time.perf_counter()
        n_recs = 0
        with open(out, "w") as fh:
            header_fn(fh, hdata)
            for _wi, _win, recs in call_pair_windows(
                    *args, precision="fast", device=dev, **kw):
                n_recs += len(recs)
                if kw["fmt"] is None:
                    for rec in recs:
                        if not isinstance(rec, SniperRecord):
                            raise AssertionError(f"fmt=None gave {type(rec)}")
                        record_fn(fh, rec)
                else:
                    fh.writelines(recs)
        wall = time.perf_counter() - t0
        stats = STATS.snapshot()
        launches = dict(gk.LAUNCHES)
        launches.update(check_card_load(stats, what))
        if body_lines(out) != fast_lines:
            raise AssertionError(f"{what}: other bytes than phase 4's fast "
                                 "output")
        print(f"  {what}: {n_recs} records, wall {wall:.3f} s "
              f"({n_cols / wall:.0f} cols/s), bytes equal to phase 4's fast "
              "output", flush=True)
        print_digest(body_lines(out))
        slabs = int(stats.get("slabs_dispatched", 0))
        if (launches["glfgen32"] != 2 * slabs or slabs == 0
                or launches["score_columns"] != slabs):
            raise AssertionError(f"{what}: {slabs} slabs launched {launches}")
        check_graphed(stats, what)
    scored = {k: int(stats.get(k, 0)) for k in
              ("device_columns", "host_deep_columns")}
    if sum(scored.values()) != n_cols:
        raise AssertionError(f"prefilter=False scored {scored}, the pair has "
                             f"{n_cols} columns")
    depths = sorted(int(k.rsplit("_", 1)[1]) for k in stats
                    if k.startswith("slabs_at_depth_"))
    print("  stage times of the prefilter=False run:\n" + STATS.summary(),
          flush=True)
    print(f"  prefilter=False: every one of the pair's {n_cols} columns "
          f"scored: {scored}; the card's share "
          f"{scored['device_columns'] / n_cols:.4%}, host_deep share "
          f"{scored['host_deep_columns'] / n_cols:.4%}; slabs "
          f"{slabs} at depth {depths}, glfgen32 launches "
          f"{launches['glfgen32']}, score_columns "
          f"{launches['score_columns']}", flush=True)
    return launches


# the inflate's window: one contig of a 250 kb window (the CLI's default
# window) of the benchmark's wgs30 pair, one sample at 30x
INFLATE_WINDOW = {"n_contigs": 1, "contig_len": 250_000}
INFLATE_SEED = 2**31 + 20


def bgzf_blocks(path: Path) -> list[tuple[bytes, int, int]]:
    """(raw DEFLATE stream, ISIZE, CRC32) of every BGZF block of a file."""
    raw = path.read_bytes()
    out, pos = [], 0
    while pos < len(raw):
        xlen = int.from_bytes(raw[pos + 10:pos + 12], "little")
        bsize = int.from_bytes(raw[pos + 16:pos + 18], "little") + 1
        crc = int.from_bytes(raw[pos + bsize - 8:pos + bsize - 4], "little")
        isize = int.from_bytes(raw[pos + bsize - 4:pos + bsize], "little")
        out.append((raw[pos + 12 + xlen:pos + bsize - 8], isize, crc))
        pos += bsize
    return out


def card_inflate_call(lib, device: int, blocks):
    """A callable that runs ``sniper_card_inflate`` on ``blocks`` (the
    loader's layout: streams one after another, outputs one after
    another), and the buffers it fills: (call, status, out, out_off)."""
    import numpy as np

    comp = np.frombuffer(b"".join(b[0] for b in blocks), np.uint8)
    in_len = np.array([len(b[0]) for b in blocks], np.int32)
    in_off = np.concatenate(([0], np.cumsum(in_len)[:-1])).astype(np.int64)
    isize = np.array([b[1] for b in blocks], np.int32)
    out_off = np.concatenate(([0], np.cumsum(isize)[:-1])).astype(np.int64)
    crc = np.array([b[2] for b in blocks], np.uint32)
    out = np.zeros(int(isize.sum()), np.uint8)
    status = np.full(len(blocks), -1, np.int32)

    def call() -> int:
        return lib.sniper_card_inflate(
            device, comp.ctypes.data, len(comp), len(blocks),
            in_off.ctypes.data, in_len.ctypes.data, isize.ctypes.data,
            crc.ctypes.data, out.ctypes.data, out_off.ctypes.data,
            status.ctypes.data)

    return call, status, out, out_off


def profiled_kernel_ms(fn, name: str, torch, reps: int = 5) -> float | None:
    """Device milliseconds a launch of the kernel ``name`` over ``reps``
    calls of ``fn``, read from torch.profiler (CUPTI sees every stream);
    None ("not measured") where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for row in prof.key_averages():
        if name in row.key:
            total_us += getattr(row, "device_time_total",
                                getattr(row, "cuda_time_total", 0.0))
            count += row.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def inflate_on_card(dev, torch) -> tuple:
    """Phase 20: ``sniper_card_inflate`` on every BGZF block of a 250 kb
    window of the benchmark's generator at 30x (the region load's shape,
    ~210 blocks of level-1 records), byte-equal to zlib, one launch a
    call of at most 256 blocks, counted where it is made; timed beside
    host zlib on one core, with the kernel's device time from the
    profiler and its byte bound.  Returns (differing bytes, ms, plain_ms,
    device_ms, plain_device_ms, bound_ms, bound_by, None) and the shape
    (blocks, output bytes)."""
    import zlib

    import numpy as np

    from somatic_sniper_tpu_torch.ops import build

    d = DATA / "inflate_window"
    if not (d / "tumor.bam").exists():
        sys.path.insert(0, str(REPO / "benchmark"))
        import pairgen

        cfg = json.loads((REPO / "benchmark" / "configs" / "wgs30.json")
                         .read_text())["data"]
        pairgen.generate(d, {**cfg, **INFLATE_WINDOW}, INFLATE_SEED,
                         workers=1)
    blocks = [b for b in bgzf_blocks(d / "tumor.bam") if b[1] > 0]
    want = [zlib.decompress(stream, -15) for stream, _, _ in blocks]
    lib = build.load_library()
    call, status, out, _ = card_inflate_call(lib, dev.index or 0, blocks)
    n0 = lib.sniper_bgzf_inflate_launches()
    rc = call()
    launches = lib.sniper_bgzf_inflate_launches() - n0
    if rc != 0 or (status != 0).any():
        raise AssertionError(f"card inflate: rc {rc}, statuses "
                             f"{sorted(set(status.tolist()))}")
    ref = np.frombuffer(b"".join(want), np.uint8)
    bad = int((out != ref).sum()) if len(ref) == len(out) else len(ref)
    if bad:
        raise AssertionError(f"card inflate: {bad} bytes differ from zlib")
    if launches != -(-len(blocks) // 256):
        raise AssertionError(f"card inflate: {len(blocks)} blocks in "
                             f"{launches} launches")

    def host_ms() -> float:
        t = time.perf_counter()
        for stream, _, _ in blocks:
            zlib.decompress(stream, -15)
        return (time.perf_counter() - t) * 1e3

    def card_ms() -> float:
        t = time.perf_counter()
        if call() != 0:
            raise AssertionError("card inflate failed")
        return (time.perf_counter() - t) * 1e3

    ms = statistics.median(card_ms() for _ in range(TIMED_REPEATS))
    plain_ms = statistics.median(host_ms() for _ in range(TIMED_REPEATS))
    dev_ms = profiled_kernel_ms(call, "bgzf_inflate_kernel", torch)
    n_in = sum(len(b[0]) for b in blocks)
    n_out = len(out)
    bound, by = bound_ms(n_in + n_out, 0)
    print(f"  bgzf_inflate {len(blocks)} blocks, {n_in} B in, {n_out} B out: "
          f"byte-equal to zlib, {launches} launch(es); per call {ms:.3f} ms "
          f"(staging, copies, kernel, wait), host zlib {plain_ms:.3f} ms; "
          f"device: kernel {fmt_ms(dev_ms)}; bound {bound:.5f} ms by {by}",
          flush=True)
    if bound > min(x for x in (ms, dev_ms) if x is not None):
        raise AssertionError("bgzf_inflate ran faster than its bound")
    return (bad, ms, plain_ms, dev_ms, None, bound, by, None), (len(blocks),
                                                               n_out)


def check_card_load(stats: dict, what: str) -> dict:
    """A windowed run on the card inflated its region loads there and
    built their pileups there: blocks handed to the card, none refused,
    one launch or more a region of at most 256 blocks
    (``launches_bgzf_inflate``, counted where the kernel is launched);
    regions built by the card builder, none on the host, at most one
    build a region (``launches_pileup_card``).  Returns the launches of
    both."""
    built = int(stats.get("native.regions_card_built", 0))
    host_built = int(stats.get("native.regions_host_built", 0))
    builds = int(stats.get("launches_pileup_card", 0))
    print(f"  {what}: card pileup build {built} regions ({builds} "
          f"launched), {host_built} built on the host", flush=True)
    if built <= 0 or host_built or not 0 < builds <= built:
        raise AssertionError(f"{what}: {built} regions built on the card, "
                             f"{host_built} on the host, {builds} builds "
                             "launched")
    blocks = int(stats.get("native.blocks_card", 0))
    redo = int(stats.get("native.blocks_card_redo", 0))
    launches = int(stats.get("launches_bgzf_inflate", 0))
    print(f"  {what}: card inflate {blocks} blocks, {redo} inflated again on "
          f"the host, {launches} bgzf_inflate launches; host-inflated "
          f"blocks {int(stats.get('native.blocks_zlib', 0))} (zlib), "
          f"{int(stats.get('native.blocks_libdeflate', 0))} (libdeflate)",
          flush=True)
    if blocks <= 0 or redo or launches <= 0 or 256 * launches < blocks:
        raise AssertionError(f"{what}: card inflate {blocks} blocks, {redo} "
                             f"redone, {launches} launches")
    return {"bgzf_inflate": launches, "pileup_build": builds}


# the deep300 configuration's pair (benchmark/configs/deep300.json),
# made once
DEEP_SEED = 2**31 + 21


def deep_pair_windows(dev) -> tuple[dict, dict]:
    """Phase 21: the ``deep300`` configuration's pair (1 Mb at 300x a
    sample, the benchmark's generator) through ``call_pair_windows`` in
    fast precision on the card, at the configuration's flags and the
    CLI's default window, twice: every survivor scored on the card in a
    slab deeper than 255 (``device_columns_deep`` = ``device_columns`` =
    ``columns_scored``, none on the host's exact scorer), every slab
    replayed from its captured step, the second run's launches
    (counters reset before it) ``accumulate`` = ``assembly10`` = 2 x
    slabs and ``score_columns`` = slabs and no other, and the records
    within the fast contract of the native exact run of the same windows.
    Returns the second fast run's (STATS deltas, launches)."""
    sys.path.insert(0, str(REPO / "benchmark"))
    import pairgen
    import run as harness

    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.parallel.sharded import call_pair_windows
    from somatic_sniper_tpu_torch.utils.contract import diff_records, hist
    from somatic_sniper_tpu_torch.utils.stats import STATS

    cfg = json.loads((REPO / "benchmark" / "configs" / "deep300.json")
                     .read_text())
    d = DATA / "deep300"
    t0 = time.perf_counter()
    if not (d / "normal.bam.bai").exists():
        pairgen.generate(d, cfg["data"], DEEP_SEED)
    args, params = harness.program_params(cfg["flags"])
    pair = (str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"))
    print(f"  deep300 pair ready in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def lines_of(precision):
        out = []
        for _wi, _w, ls in call_pair_windows(
                *pair, fmt="vcf", params=params, precision=precision,
                window_size=int(args.window_size), device=dev):
            out.extend(ls)
        return out

    walls = {}
    for turn in (1, 2):
        s0 = STATS.snapshot()
        gk.reset_launches()
        t0 = time.perf_counter()
        fast = lines_of("fast")
        walls[f"fast_{turn}"] = time.perf_counter() - t0
        s1 = STATS.snapshot()
        launches = {k: v for k, v in gk.LAUNCHES.items() if v}
    stats = {k: v - s0.get(k, 0) for k, v in s1.items()
             if v - s0.get(k, 0)}
    t0 = time.perf_counter()
    exact = lines_of("exact")
    walls["exact"] = time.perf_counter() - t0
    n = {k: int(stats.get(k, 0)) for k in (
        "columns_scored", "device_columns", "device_columns_deep",
        "host_deep_columns", "slabs_dispatched", "slabs_graphed",
        "slab_bytes_uploaded")}
    depths = {k: int(v) for k, v in stats.items()
              if k.startswith("slabs_at_depth_")}
    slabs = n["slabs_dispatched"]
    print(f"  deep300 on {dev}: {json.dumps(n)}, slabs by depth "
          f"{json.dumps(depths)}, launches {json.dumps(launches)}; walls "
          f"(s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}",
          flush=True)
    if (n["columns_scored"] <= 0 or slabs <= 0
            or n["device_columns_deep"] != n["device_columns"]
            or n["device_columns"] != n["columns_scored"]
            or n["host_deep_columns"]
            or n["slabs_graphed"] != slabs
            or any(int(k.rpartition("_")[2]) <= 255 for k in depths)):
        raise AssertionError(f"deep300: the survivors were not scored on "
                             f"the card in deep slabs: {n}, {depths}")
    if launches != {"accumulate": 2 * slabs, "assembly10": 2 * slabs,
                    "score_columns": slabs}:
        raise AssertionError(f"deep300: {slabs} slabs launched {launches}")
    tolerated = diff_records(fast, exact, "vcf")
    print(f"  deep300: {len(fast)} records, within the fast contract of "
          f"the native exact run; hist {json.dumps(hist(tolerated))}",
          flush=True)
    return stats, launches


# the card build's 300x window: one contig of a 250 kb window of the
# deep300 configuration's generator, one sample
PILEUP_SEED_300 = 2**31 + 23


def profiled_call_ms(fn, names, torch, reps: int = 5) -> float | None:
    """Device milliseconds a call of ``fn`` spends in the kernels whose
    names hold one of ``names``, read from torch.profiler over ``reps``
    calls; None ("not measured") where the profiler shows none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(row, "device_time_total",
                           getattr(row, "cuda_time_total", 0.0))
                   for row in prof.key_averages()
                   if any(n in row.key for n in names))
    return total_us / reps / 1e3 if total_us > 0 else None


def pileup_on_card(dev, torch) -> tuple[dict, int]:
    """Phase 23: a region load's pileup build on the card
    (``sniper_card_pileup``, registered with the native loader) on a
    250 kb window of the benchmark's generator at 30x and at 300x, one
    sample: ukeys, offsets, slots and pure-reference flags byte-equal to
    the host build's, one launch a load.  Timed beside the host build:
    the call ms is the loader's ``pileup_build`` seconds a load (the
    thread's wait on the card: copies, kernels, the host arrays), the
    host's its ``pileup_build`` and ``pure_flags``; the device ms is the
    four kernels' a load (torch.profiler); the bound is the bytes the
    build cannot avoid: each entry's slot word written and its base and
    quality read (5.5 bytes), each column's key, offset and flag (17
    bytes).  Returns {"30x" / "300x": (differing elements, ms, host ms,
    device ms, None, bound ms, "bytes", shape)} and the launches."""
    import numpy as np

    from somatic_sniper_tpu_torch.io import bai, native, native_api
    from somatic_sniper_tpu_torch.io.bam import read_bam_header
    from somatic_sniper_tpu_torch.io.fasta import FastaFile
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables)
    from somatic_sniper_tpu_torch.ops import build
    from somatic_sniper_tpu_torch.pileup.prefilter import prefilter_tables
    from somatic_sniper_tpu_torch.runner import _ref_blob

    sys.path.insert(0, str(REPO / "benchmark"))
    import pairgen

    lib = build.load_library()
    nlib = native.get_lib()
    native.set_card_inflate(None, dev.index or 0)  # the builder's device
    address = build.card_pileup_addresses()
    tabs = build_tables(ModelParams())
    gmin, margin = prefilter_tables(tabs)
    out, launches = {}, 0
    end = INFLATE_WINDOW["contig_len"]
    for label, config, seed, d in (
            ("30x", "wgs30", INFLATE_SEED, DATA / "inflate_window"),
            ("300x", "deep300", PILEUP_SEED_300, DATA / "pileup_window_300")):
        if not (d / "tumor.bam.bai").exists():
            cfg = json.loads((REPO / "benchmark" / "configs"
                              / f"{config}.json").read_text())["data"]
            pairgen.generate(d, {**cfg, **INFLATE_WINDOW}, seed)
        bam = str(d / "tumor.bam")
        header = read_bam_header(bam)
        blob, off = _ref_blob(FastaFile(str(d / "ref.fa")), header)
        ch = np.asarray(bai.region_chunks(bai.ensure_index(bam), 0, 0, end),
                        np.int64).reshape(-1, 2)

        def load(card: bool):
            native.set_card_pileup(address if card else None)
            s0 = native.load_counters(nlib)[0]
            pu = native_api.load_region_and_columnize(
                bam, ch, 0, 0, end, n_threads=1,
                flag_args=(blob, off, tabs.fk, gmin, margin))
            s1 = native.load_counters(nlib)[0]
            ms = 1e3 * sum(s1[f"native.{k}"] - s0[f"native.{k}"]
                           for k in ("pileup_build", "pure_flags"))
            c = pu.owner._ptr.contents
            arrays = (np.array(pu.ukeys), np.array(pu.offsets),
                      np.array(pu.slots),
                      np.ctypeslib.as_array(c.pure, (len(pu.ukeys),)).copy())
            return arrays, ms

        try:
            want, _ = load(False)
            n0 = lib.sniper_pileup_card_launches()
            got, _ = load(True)
            n_launch = lib.sniper_pileup_card_launches() - n0
            bad = sum(len(a) if len(a) != len(b) else int((a != b).sum())
                      for a, b in zip(want, got))
            if bad or n_launch != 1:
                raise AssertionError(
                    f"card pileup build, {label}: {bad} elements differ "
                    f"from the host build's, {n_launch} launches")
            launches += n_launch
            ms = statistics.median(load(True)[1]
                                   for _ in range(TIMED_REPEATS))
            host_ms = statistics.median(load(False)[1]
                                        for _ in range(TIMED_REPEATS))
            dev_ms = profiled_call_ms(lambda: load(True),
                                      KERNEL_FUNCS["pileup_build"], torch)
        finally:
            native.set_card_pileup(None)
        n_cols, n_entries = len(want[0]), len(want[2])
        bound, by = bound_ms(int(n_entries * 5.5) + 17 * n_cols, 0)
        shape = (n_cols, round(n_entries / n_cols))
        print(f"  pileup_build {label}: {n_cols} columns, {n_entries} "
              f"entries: byte-equal to the host build, {n_launch} launch; "
              f"per load {ms:.3f} ms (copies, kernels, the host arrays), "
              f"host build {host_ms:.3f} ms; device: kernels "
              f"{fmt_ms(dev_ms)}; bound {bound:.5f} ms by {by}", flush=True)
        if bound > min(x for x in (ms, dev_ms) if x is not None):
            raise AssertionError("pileup_build ran faster than its bound")
        out[label] = (bad, ms, host_ms, dev_ms, None, bound, by, shape)
    return out, launches


def deep_kernels(stats: dict, dev, torch, floor_ms: float) -> dict:
    """Phase 22: kernels_at_path_shapes over the slab shapes phase 21 ran
    (family ``deep``).  Returns its {(name, shape): ...}."""
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.parallel.slab import slab_b

    shapes = {"deep": path_shapes(stats, "slabs_at_depth_",
                                  lambda n: slab_b())}
    print(f"  deep slab shapes, most-used first: {json.dumps(shapes)}",
          flush=True)
    dtabs = device_tables(build_tables(ModelParams()), dev)
    return kernels_at_path_shapes(shapes, dtabs, dev, torch, floor_ms)


def launch_floor_ms(dev, torch) -> float:
    """Queued ms of FLOOR_GRID's empty kernel.  It never waits: a timing
    whose spin ran out before the host had queued the launches is the
    host's hiccup, measured again."""
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    for _ in range(3):
        floor_ms = queued_ms(lambda: gk.empty_launch(*FLOOR_GRID, dev), torch)
        if floor_ms is not None:
            return floor_ms
    raise AssertionError("the empty kernel's launches waited three times")


def deep() -> int:
    """``python3 chip_smoke.py --deep``: phases 1-2, phase 17 at the slab
    tiers from 255 up, 21 and 22."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from somatic_sniper_tpu_torch.device import resolve_device
    from somatic_sniper_tpu_torch.io import native
    from somatic_sniper_tpu_torch.ops import build
    from somatic_sniper_tpu_torch.parallel.slab import ALLOWED_D

    t_start = time.perf_counter()
    phase("1 card")
    card = card_line()
    print(card, flush=True)
    dev = resolve_device("cuda")
    phase("2 build")
    if native.get_lib() is None:
        raise AssertionError("the port's native host library did not build")
    build.build()
    build.load_library()
    floor_ms = launch_floor_ms(dev, torch)
    phase("17 the captured step against the eager one, deep tiers")
    graphed_against_eager(dev, torch,
                          depths=[D for D in ALLOWED_D if D >= 255])
    phase("21 the deep300 pair, fast on the card vs exact")
    stats, _ = deep_pair_windows(dev)
    phase("22 the deep slab step's kernels at phase 21's shapes")
    deep_kernels(stats, dev, torch, floor_ms)
    print(f"  --deep wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def pileup() -> int:
    """``python3 chip_smoke.py --pileup``: phases 1-2 and 23."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from somatic_sniper_tpu_torch.device import resolve_device
    from somatic_sniper_tpu_torch.io import native
    from somatic_sniper_tpu_torch.ops import build

    phase("1 card")
    card = card_line()
    print(card, flush=True)
    dev = resolve_device("cuda")
    phase("2 build")
    if native.get_lib() is None:
        raise AssertionError("the port's native host library did not build")
    build.build()
    for kernel, use in sorted(build.resource_usage().items()):
        if kernel in KERNEL_FUNCS["pileup_build"]:
            print(f"  {kernel}: {use['registers']} registers a thread, "
                  f"{use.get('spill_bytes', 0)} bytes spilled, "
                  f"{use['smem_bytes']} bytes of static shared memory",
                  flush=True)
    phase("23 the card pileup build at the region load's shape")
    pileup_on_card(dev, torch)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


NO_TORCH_CHILD = """\
import sys
sys.modules["jax"] = None
sys.modules["somatic_sniper_tpu"] = None
from somatic_sniper_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
if rc == 0 and "torch" in sys.modules:
    sys.exit("the run imported torch")
sys.exit(rc)
"""


def cli_without_a_card(out_dir: Path) -> None:
    """Phase 16: the default ``--device`` where no card is visible.  The
    exact run needs none (and no torch); the fast run stops with the
    device's message."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    inputs = ["-F", "vcf", "-f", str(GOLDEN / "small.fa"),
              str(GOLDEN / "t-small.bam"), str(GOLDEN / "n-small.bam")]
    walls = {}
    for precision, want_rc in (("exact", 0), ("fast", 1)):
        out = out_dir / f"no_card_{precision}.vcf"
        out.unlink(missing_ok=True)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", NO_TORCH_CHILD, "--precision", precision,
             *inputs, str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        walls[precision] = time.perf_counter() - t0
        if r.returncode != want_rc:
            raise AssertionError(f"{precision} CLI without a card exited "
                                 f"{r.returncode}:\n{r.stderr[-2000:]}")
        if precision == "exact":
            if body_lines(out) != body_lines(GOLDEN / "expected.vcf"):
                raise AssertionError("exact without a card differs from "
                                     "tests/data/expected.vcf")
        elif "no CUDA device is available" not in r.stderr or out.exists():
            raise AssertionError(f"fast without a card: {r.stderr[-2000:]}")
    print(f"  CUDA_VISIBLE_DEVICES='', default --device: exact exits 0 with "
          f"the golden bytes and without importing torch "
          f"({walls['exact']:.3f} s, child process); fast exits 1 with the "
          f"device's message ({walls['fast']:.3f} s)", flush=True)


def run_cli(args: list[str]) -> float:
    from somatic_sniper_tpu_torch.cli.main import main

    t0 = time.perf_counter()
    rc = main(args)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {args}")
    return wall


def body_lines(path: Path) -> list[str]:
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith(("##fileDate", "##reference="))]


def print_digest(lines: list[str]) -> None:
    """The fast output's sha256, to hold two commits' smokes to each
    other byte for byte."""
    sha = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    print(f"  fast output: {len(lines)} lines, sha256 {sha}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    phase("1 card")
    card = card_line()
    print(card, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    from somatic_sniper_tpu_torch.device import resolve_device
    from somatic_sniper_tpu_torch.io import native
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import build
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.parallel.slab import slab_b
    from somatic_sniper_tpu_torch.runner import MAX_BATCH, _b_bucket
    from somatic_sniper_tpu_torch.utils.contract import diff_records, hist
    from somatic_sniper_tpu_torch.utils.stats import STATS

    dev = resolve_device("cuda")
    phase("2 build")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the port's native host library did not build "
                             "or load (g++ and zlib are needed)")
    print(f"  native host library ready in {time.perf_counter() - t0:.2f} s "
          "(built from somatic_sniper_tpu_torch/io/native/sniper_native.cpp "
          "unless already there)", flush=True)
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    registers = build.resource_usage()
    for kernel, use in sorted(registers.items()):
        print(f"  {kernel}: {use['registers']} registers a thread, "
              f"{use.get('spill_bytes', 0)} bytes spilled, "
              f"{use['smem_bytes']} bytes of static shared memory",
              flush=True)
    floor_ms = launch_floor_ms(dev, torch)
    print(f"  {card}: launch floor {floor_ms:.4f} ms (an empty kernel "
          f"of {FLOOR_GRID[0]} blocks of {FLOOR_GRID[1]} threads, "
          f"{TIMED_RUNS} queued back to back)", flush=True)

    phase("3 kernels against their plain versions on the card")
    dtabs = device_tables(build_tables(ModelParams()), dev)
    errs = {name: 0.0 for name in KERNELS}
    for shapes, cases in ((SHAPES, slab_cases), (RANK_SHAPES, rank_cases)):
        for B, D in shapes:
            for name, case in cases(B, D, dtabs, dev, torch).items():
                t = timed(name, (B, D), case, torch, floor_ms)
                errs[name] = max(errs[name], t[0])
    errs["accumulate"] = max(errs["accumulate"],
                             hazard_check(dtabs, dev, torch))
    # the scoring step after glfgen: slab shapes with the dqstats, the
    # batch path's main shape without
    for (B, D), dq in [*((shape, True) for shape in SHAPES),
                       ((65536, 40), False)]:
        timed("score_columns", (B, D), score_case(B, D, dev, torch, dq),
              torch, floor_ms)
        if (B, D) in ((8192, 48), (65536, 40)):
            score_joint(B, D, dq, dev, torch, floor_ms)
    for D in EDGE_DEPTHS:
        cases = rank_cases(EDGE_B, D, dtabs, dev, torch)
        if D <= 255:
            cases.update(slab_cases(EDGE_B, D, dtabs, dev, torch))
        for name, case in cases.items():
            errs[name] = max(errs[name], case.err)
        print(f"  edge depth B={EDGE_B} D={D:3d}: " + ", ".join(
            f"{name} equal (max_abs_err {case.err:.3g})"
            for name, case in cases.items()), flush=True)

    phase("4 main path: 10 Mb pair at 30x, fast on the card vs exact")
    pair, n_cols = ensure_sim("pair_10mb", SIM, index=True)
    out_dir = DATA / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    common = ["-F", "vcf", "-f", str(pair / "ref.fa"),
              str(pair / "tumor.bam"), str(pair / "normal.bam")]
    fast = ["--precision", "fast", "--device", "cuda", *common]
    exact = ["--precision", "exact", "--device", "cuda", *common]
    # the counted main-path run: counters from zero, read right after
    STATS.reset()
    gk.reset_launches()
    walls = {"fast": [run_cli([*fast, str(out_dir / "fast.vcf")])]}
    launches = dict(gk.LAUNCHES)
    stats = STATS.snapshot()
    launches.update(check_card_load(stats, "phase 4"))
    # timed repeats, alternated on the same card: exact, fast, exact
    walls["exact"] = [run_cli([*exact, str(out_dir / "exact.vcf")])]
    STATS.reset()
    walls["fast"].append(run_cli([*fast, str(out_dir / "fast2.vcf")]))
    fast_summary = STATS.summary()
    walls["exact"].append(run_cli([*exact, str(out_dir / "exact2.vcf")]))
    fast_lines = body_lines(out_dir / "fast.vcf")
    tol = diff_records(fast_lines, body_lines(out_dir / "exact.vcf"), "vcf")
    if body_lines(out_dir / "fast2.vcf") != fast_lines:
        raise AssertionError("two fast runs gave different bytes")
    slabs = int(stats.get("slabs_dispatched", 0))
    depths = sorted(int(k.rsplit("_", 1)[1]) for k in stats
                    if k.startswith("slabs_at_depth_"))
    print(f"  columns {n_cols}, output lines {len(fast_lines)}", flush=True)
    print_digest(fast_lines)
    for mode, ws in walls.items():
        print(f"  {mode:5s} wall " + ", ".join(
            f"{w:.3f} s ({n_cols / w:.0f} cols/s)" for w in ws), flush=True)
    print("  stage times of the second fast run:\n" + fast_summary,
          flush=True)
    for key in ("slabs_dispatched", "device_columns", "host_deep_columns"):
        print(f"  {key} {int(stats.get(key, 0))}", flush=True)
    print(f"  slab depths {depths}, launches {launches}", flush=True)
    print(f"  contract ok, hist {json.dumps(hist(tol), sort_keys=True)}",
          flush=True)
    if int(stats.get("device_columns", 0)) <= 0:
        raise AssertionError("no column was scored on the device")
    # one fused launch a sample a slab, and no stand-alone kernel: no
    # slab waits on assembly10's error word
    if (slabs == 0 or launches["glfgen32"] != 2 * slabs
            or launches["score_columns"] != slabs
            or launches["accumulate32"] or launches["assembly10"]):
        raise AssertionError(f"{slabs} slabs launched {launches}")
    check_graphed(stats, "phase 4")
    phase("5 golden pair, fast on the card")
    gold_out = out_dir / "golden_fast.vcf"
    run_cli(["--precision", "fast", "--device", "cuda", "-F", "vcf",
             "-f", str(GOLDEN / "small.fa"), str(GOLDEN / "t-small.bam"),
             str(GOLDEN / "n-small.bam"), str(gold_out)])
    gtol = diff_records(body_lines(gold_out),
                        body_lines(GOLDEN / "expected.vcf"), "vcf")
    print_digest(body_lines(gold_out))
    print(f"  contract ok, hist {json.dumps(hist(gtol), sort_keys=True)}",
          flush=True)

    phase("6 batch path, full-u32 batches: 10 Mb pair, whole file")
    loaded, t_load = load_u32_pair(pair, dev)
    launches_u32, stats_u32 = u32_batches(
        loaded, t_load, n_cols, body_lines(out_dir / "exact.vcf"), dev, torch)

    phase("7 CLI without the native library: 1 Mb pair, u16 batches")
    launches_u16, stats_u16 = cli_without_native(out_dir, torch)

    phase("8 kernels at the shapes the paths ran")
    # slabs are slab_b() columns; a batch holds at most max_batch
    # columns of one depth, so its largest is min(columns, max_batch),
    # padded to its bucket
    shapes = {
        "slab": path_shapes(stats, "slabs_at_depth_", lambda n: slab_b()),
        "u32": path_shapes(stats_u32, "batch_columns_at_depth_",
                           lambda n: _b_bucket(min(n, MAX_BATCH))),
        "u16": path_shapes(stats_u16, "batch_columns_at_depth_",
                           lambda n: _b_bucket(min(n, MAX_BATCH))),
    }
    print(f"  shapes, most-used first: {json.dumps(shapes)}", flush=True)
    at_path = kernels_at_path_shapes(shapes, dtabs, dev, torch, floor_ms)
    for (name, _), t in at_path.items():
        errs[name.split("/")[0]] = max(errs[name.split("/")[0]], t[0])

    phase("9 --jobs 1, 2, 4: 10 Mb pair, fast on the card, child processes")
    launches_jobs = jobs_runs(common, out_dir, fast_lines, n_cols,
                              walls["fast"])

    phase("10 --merge collective: two processes on the one card")
    launches_coll = collective_runs(common, out_dir, fast_lines, n_cols)

    phase("11 the exact f64 glfgen on the card")
    _, stats_exact = u32_batches(loaded, t_load, n_cols,
                                 body_lines(out_dir / "exact.vcf"), dev,
                                 torch, precision="exact")
    del loaded
    exact_golden_without_native(out_dir)

    phase("13 bench_kernel: the scoring step on the card")
    bench_kernel_on_card(dev, torch)

    phase("14 entry(): the forward step on the card against the CPU")
    entry_on_card(torch)

    phase("15 records (fmt=None) and prefilter=False: 10 Mb pair, fast")
    launches_nopf = records_and_prefilter(pair, out_dir, fast_lines, n_cols,
                                          dev)

    phase("16 the default --device with no card visible")
    cli_without_a_card(out_dir)

    phase("17 the captured step against the eager step")
    graphed_against_eager(dev, torch)

    phase("18 the captured batch step against the eager step")
    # and a fast key deeper than 255, which no phase's data reaches
    graphed_batches_against_eager(
        {key for st in (stats_u32, stats_u16, stats_exact)
         for key in batch_keys(st)} | {("u32", "fast", 4096, 300)},
        dev, torch)
    deep_error_word(dev, torch)

    phase("20 the card inflate at the region load's shape")
    inflate_t, inflate_shape = inflate_on_card(dev, torch)
    at_path["bgzf_inflate", inflate_shape] = inflate_t
    errs["bgzf_inflate"] = inflate_t[0]
    phase("21 the deep300 pair, fast on the card vs exact")
    stats_deep, launches_deep = deep_pair_windows(dev)
    phase("22 the deep slab step's kernels at phase 21's shapes")
    at_deep = deep_kernels(stats_deep, dev, torch, floor_ms)
    for (name, _), t in at_deep.items():
        errs[name.split("/")[0]] = max(errs[name.split("/")[0]], t[0])
    deep_shape = next(sh for (name, sh), t in at_deep.items()
                      if name == "accumulate" and len(t) > 1)
    phase("23 the card pileup build at the region load's shape")
    pileup_t, _ = pileup_on_card(dev, torch)
    pileup_shape = pileup_t["30x"][7]
    at_path["pileup_build", pileup_shape] = pileup_t["30x"]
    errs["pileup_build"] = max(t[0] for t in pileup_t.values())

    # each kernel's launches from the phase that ran it, its times at
    # the main shape of its path (phase 8)
    runs = {
        "accumulate32": (launches, shapes["slab"][0]),
        "assembly10": (launches, shapes["slab"][0]),
        "accumulate": (launches_u32, shapes["u32"][0]),
        "accumulate16": (launches_u16, shapes["u16"][0]),
        "glfgen32": (launches, shapes["slab"][0]),
        "glfgen": (launches_u32, shapes["u32"][0]),
        "glfgen16": (launches_u16, shapes["u16"][0]),
        "score_columns": (launches, shapes["slab"][0]),
        "bgzf_inflate": (launches, inflate_shape),
        "pileup_build": (launches, pileup_shape),
    }
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        counts, shape = runs[name]
        # a stand-alone kernel's code ran on its path inside the fused
        # kernel named by fused_as: those launches are its launches, and
        # its own entry's count is given beside them
        fused_as = FUSED_AS.get(name)
        extra = {} if fused_as is None else {
            "fused_as": fused_as, "standalone_launches": counts[name]}
        if fused_as is None:
            extra["registers"] = {
                k: v["registers"] for k, v in sorted(registers.items())
                if k in KERNEL_FUNCS.get(name, ()) or k == f"{name}_kernel"
                or k.startswith(f"{name}_kernel<")}
        if name == "pileup_build":
            # the 300x window (phase 23)
            _, d_ms, d_pms, d_dms, _, d_bound, d_by, d_shape = \
                pileup_t["300x"]
            extra["deep_window"] = {
                "shape": list(d_shape), "ms": d_ms, "plain_ms": d_pms,
                "device_ms": d_dms, "bound_ms": d_bound, "bound_by": d_by,
                "bound_share_of_device_ms": (None if d_dms is None
                                             else d_bound / d_dms)}
        _, ms, pms, dms, pdms, bound, by, _ = at_path[name, shape]
        if name == "score_columns":
            # every timed call of phase 8: solo at each path's main shape,
            # then joint
            extra["timed"] = [
                {"mode": k.partition("/")[2] or "solo", "shape": list(sh),
                 "ms": t[1], "device_ms": t[3], **t[7]}
                for (k, sh), t in at_path.items()
                if k.partition("/")[0] == name and len(t) > 1]
        if name in ("accumulate", "assembly10", "score_columns"):
            # the slab step above D 255 (phases 21 and 22)
            _, d_ms, d_pms, d_dms, d_pdms, d_bound, d_by, _ = \
                at_deep[name, deep_shape]
            extra["deep_slab"] = {
                "launches": launches_deep.get(name, 0),
                "shape": list(deep_shape), "ms": d_ms, "plain_ms": d_pms,
                "device_ms": d_dms, "plain_device_ms": d_pdms,
                "bound_ms": d_bound, "bound_by": d_by,
                "bound_share_of_device_ms": (None if d_dms is None
                                             else d_bound / d_dms)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[fused_as or name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by,
            # no one PyTorch call ranks reads within their classes,
            # assembles the ten genotype likelihoods or scores a column
            "library_ms": None,
            "device_ms": dms, "plain_device_ms": pdms,
            "bound_share_of_device_ms": None if dms is None else bound / dms,
            "shape": list(shape), **extra,
        })
    print(f"  smoke wall {time.perf_counter() - t_start:.1f} s, set-up "
          "(both builds, the simulated pairs) included", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels,
                      "launch_floor_ms": floor_ms,
                      "launch_floor_grid": list(FLOOR_GRID),
                      # launches of the paths of phases 9, 10 and 15,
                      # each counted from zero over its own run
                      "path_launches": {
                          **{f"jobs_{n}": v
                             for n, v in launches_jobs.items()},
                          "collective_2": launches_coll,
                          "windows_prefilter_off": {
                              k: launches_nopf[k]
                              for k in ("glfgen32", "score_columns",
                                        "bgzf_inflate", "pileup_build")}}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# score_columns with the dqstats (the slab step's instance) at slabs of
# fewer columns than the default 8192 (SNIPER_SLAB_B) and at depths to 255
# (SNIPER_SLAB_D): a thread walks a column's whole row, so a small B with
# deep rows leaves most SMs idle
SWEEP_B = (512, 1024, 2048, 4096, 8192)
SWEEP_D = (48, 128, 255)


def score_sweep() -> int:
    """``python3 chip_smoke.py --score-sweep``: score_columns at every
    (B, D) of SWEEP_B x SWEEP_D, held to its plain version on the timed
    inputs and timed beside its bounds.  It uses only the port's
    ``score_columns`` API, so a copy of this file dropped into an older
    checkout times that checkout's kernel."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from somatic_sniper_tpu_torch.device import resolve_device
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    floor_ms = queued_ms(lambda: gk.empty_launch(*FLOOR_GRID, dev), torch)
    for D in SWEEP_D:
        for B in SWEEP_B:
            timed("score_columns", (B, D),
                  score_case(B, D, dev, torch, dq=True, check=False), torch,
                  floor_ms)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--score-sweep"]:
        sys.exit(score_sweep())
    if sys.argv[1:] == ["--deep"]:
        sys.exit(deep())
    if sys.argv[1:] == ["--pileup"]:
        sys.exit(pileup())
    if sys.argv[1:]:
        sys.exit("usage: python3 chip_smoke.py [--score-sweep | --deep | "
                 "--pileup]")
    sys.exit(main())
