"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, so a failed phase exits non-zero and the
closing ``{"ok": true, ...}`` line is never printed):

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the port's native host library (g++) and of the CUDA kernels
   (nvcc) from the sources under ``somatic_sniper_tpu_torch/``;
3. each kernel against its plain torch version on the card, with the
   median time of 20 timed calls of each: ``accumulate32`` and
   ``assembly10`` on random raw slabs at slab shapes; ``accumulate`` and
   ``accumulate16`` on random column batches from depth bucket 16 to
   8192 and an oversize column, plus the floored-rank hazard column, the
   assembly after the c_tot > 255 rescale, and the three rank kernels at
   the depths on both sides of every keys-per-lane step of the warp
   layout, with a batch size that fills no whole block, launched twice
   for equal bits;
4. the main path at a size users run: the port's CLI on a simulated
   10 Mb tumor/normal pair at 30x (windowed driver), fast precision on
   the card against exact precision (native host scoring) under the fast
   contract, with the launch counters proving the run went through both
   kernels;
5. fast precision on the card against the golden pair's expected VCF;
6. the batch path with full-u32 batches (the no-reference route, with
   the reference's ref16 so sites emit) on the 10 Mb pair, whole-file,
   against phase 4's exact output, through ``accumulate``;
7. the port's CLI with the native library missing (pure-Python decode,
   u16 batches through ``accumulate16``) on a 1 Mb pair at 30x, in a
   child process, against the port's native exact output;
8. each kernel against its plain version again at every (B, D) its path
   ran in phases 4, 6 and 7 (read from the runs' per-depth counters),
   timed at the shape that carried the most columns: the times of the
   ``kernels`` line, each beside its bound (the least time the card
   could take: the bytes the inputs need over the memory rate, or the
   operations over the f32 rate, whichever is larger).  A kernel faster
   than its bound is a fault of the count and fails the run.

Its first statements make ``import jax`` and ``import somatic_sniper_tpu``
fail, so a pass also shows that the port needs neither; it imports only
the port (``somatic_sniper_tpu_torch``).  The simulated pair is cached
in ``chip_smoke_data/`` (gitignored) and regenerated when missing.
"""

import sys

sys.modules["jax"] = None  # any import of JAX from here on raises
sys.modules["somatic_sniper_tpu"] = None  # and any of the JAX package

import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

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
# f32 operations a column of assembly10 takes (counted from its plain
# version: ten genotype sums, the two scans, the quantization)
ASSEMBLY_FLOPS_PER_COLUMN = 220
SIM = dict(n_contigs=2, contig_len=5_000_000, mean_depth=30.0, seed=11)
SIM_1MB = dict(n_contigs=1, contig_len=1_000_000, mean_depth=30.0, seed=12)
KERNELS = {
    "accumulate32": ("somatic_sniper_tpu_torch/ops/csrc/accumulate32.cu",
                     "somatic_sniper_tpu/ops/pallas_glfgen.py:578"),
    "assembly10": ("somatic_sniper_tpu_torch/ops/csrc/assembly10.cu",
                   "somatic_sniper_tpu/ops/pallas_glfgen.py:526"),
    "accumulate": ("somatic_sniper_tpu_torch/ops/csrc/accumulate.cu",
                   "somatic_sniper_tpu/ops/pallas_glfgen.py:717"),
    "accumulate16": ("somatic_sniper_tpu_torch/ops/csrc/accumulate16.cu",
                     "somatic_sniper_tpu/ops/pallas_glfgen.py:652"),
}


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


def device_ms(fn, torch) -> float | None:
    """Device milliseconds per call: queued_ms where the calls never wait
    for the device (the rank kernels' wrappers), else profiled_ms
    (``assembly10`` reads its error word; the plain versions sync)."""
    fn()
    torch.cuda.synchronize()
    ms = queued_ms(fn, torch)
    return ms if ms is not None else profiled_ms(fn, torch)


def queued_ms(fn, torch) -> float | None:
    """A spin kernel holds the stream while the host queues TIMED_RUNS
    calls; two CUDA events then time them back to back on the device
    (launch gaps included), divided by TIMED_RUNS; the median of
    TIMED_REPEATS.  None when the timed calls started before the host had
    queued them all: a call waited for the device."""
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


def profiled_ms(fn, torch) -> float | None:
    """Device milliseconds per call from torch.profiler: the self device
    time of every kernel, copy and fill that TIMED_RUNS calls ran,
    divided by TIMED_RUNS.  The profiler can drop events, so a profile
    counts only when it holds TIMED_RUNS times the device events of one
    profiled call (three tries); None when none does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n: int) -> tuple[int, float]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        return (sum(e.count for e in evs),
                sum(e.self_device_time_total for e in evs))

    per_call, _ = run(1)
    for _ in range(3):
        n, us = run(TIMED_RUNS)
        if per_call and n == per_call * TIMED_RUNS and us > 0:
            return us / TIMED_RUNS / 1e3
    return None


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


def slab_cases(B: int, D: int, dtabs, dev, torch) -> dict:
    """accumulate32, then assembly10 on its sums, against their plain
    versions on random raw slab lanes at (B, D) (c, rms, lk and min_lk
    equal).  Returns {name: (max_abs_err, kernel call, plain call,
    (bound_ms, bound_by))}."""
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
    lanes = int(nk.clamp(max=D).sum())
    taken = int(k[2].sum())
    # assembly10: three [B, 4] arrays and n in, lk[10], min_lk and the
    # error word out; of the tables, the entries the gathers can touch
    # (ten coef and six lhet reads a column), at most the whole tables
    coef_sub, lhet_sub = args[4], args[5]
    table_bytes = min(4 * (coef_sub.numel() + lhet_sub.numel()), 64 * B)
    return {
        "accumulate32": (acc_err, lambda: gk.accumulate32(s, nk, r, w, 60),
                         lambda: gk.accumulate32_plain(s, nk, r, w, 60),
                         rank_bound(lanes, 4, B, 2, 13, taken)),
        "assembly10": (float((lk - lk_p).abs().max()),
                       lambda: gk.assembly10(*args),
                       lambda: gk.assembly10_plain(*args),
                       bound_ms(4 * B * (13 + 11) + 4 + table_bytes,
                                ASSEMBLY_FLOPS_PER_COLUMN * B)),
    }


def rank_cases(B: int, D: int, dtabs, dev, torch,
               names=("accumulate", "accumulate16")) -> dict:
    """accumulate (full u32 slots, deletions included) and accumulate16
    (the same columns as u16 lanes) against their plain versions at
    (B, D): c, rms and n equal, the sums within check_sums; past D = 255
    also assembly10 after the c_tot > 255 rescale; a second launch of
    each gives the same bits.  Returns {name: (max_abs_err, kernel call,
    plain call, (bound_ms, bound_by))}."""
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
        cases["accumulate"] = (
            err, lambda: gk.accumulate(s, dp, r, w, 60),
            lambda: gk.accumulate_plain(s, dp, r, w, 60),
            rank_bound(int(depth.clip(0, D).sum()), 4, B, 2, 14,
                       int(k[2].sum())))
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
        cases["accumulate16"] = (
            check_sums("accumulate16", k16, p16, (B, D), torch),
            lambda: gk.accumulate16(l16, n16, w),
            lambda: gk.accumulate16_plain(l16, n16, w),
            rank_bound(int(nk.clip(0, D).sum()), 2, B, 1, 12,
                       int(k16[2].sum())))
    return cases


def timed(name: str, shape, case, torch) -> tuple:
    """(max_abs_err, ms, plain_ms, device_ms, plain_device_ms, bound_ms,
    bound_by) of one case, printed.  A kernel that beats its bound shows
    a fault of the count: that raises."""
    err, kern, plain, (bound, by) = case
    t = (err, call_ms(kern, torch), call_ms(plain, torch),
         device_ms(kern, torch), device_ms(plain, torch), bound, by)
    share = "" if t[3] is None else f" ({100 * bound / t[3]:.1f}% of it)"
    print(f"  {name:13s} B={shape[0]:5d} D={shape[1]:5d}  max_abs_err={err:.3g}"
          f"  per call: kernel {t[1]:.4f} ms, plain {t[2]:.4f} ms; "
          f"device: kernel {fmt_ms(t[3])}, plain {fmt_ms(t[4])}; "
          f"bound {bound:.5f} ms by {by}{share}", flush=True)
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


def kernels_at_path_shapes(shapes: dict, dtabs, dev, torch) -> dict:
    """Phase 8: every kernel against its plain version at every shape its
    path ran (random lanes), timed at the path's main shape (the first:
    the depth that carried the most columns).  ``shapes`` maps a family
    ("slab", "u32", "u16") to its shapes.  Returns {(name, shape):
    (max_abs_err, ms, plain_ms, device_ms, plain_device_ms, bound_ms,
    bound_by) or (max_abs_err,)}."""
    family = {"slab": None, "u32": ("accumulate",), "u16": ("accumulate16",)}
    out = {}
    for fam, fam_shapes in shapes.items():
        for i, (B, D) in enumerate(fam_shapes):
            cases = (slab_cases(B, D, dtabs, dev, torch) if fam == "slab"
                     else rank_cases(B, D, dtabs, dev, torch, family[fam]))
            for name, case in cases.items():
                if i == 0:
                    out[name, (B, D)] = timed(name, (B, D), case, torch)
                else:
                    out[name, (B, D)] = (case[0],)
                    print(f"  {name:13s} B={B:5d} D={D:5d}  equal, "
                          f"max_abs_err={case[0]:.3g}", flush=True)
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


def u32_batches(pair: Path, n_cols: int, exact_lines: list[str], dev,
                torch) -> tuple[dict, dict]:
    """Phase 6: the whole-file batch path with full-u32 batches on the
    10 Mb pair.  Returns (launches, stats) of the counted run."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.io.bam import read_bam_header
    from somatic_sniper_tpu_torch.io.fasta import FastaFile
    from somatic_sniper_tpu_torch.models.tables import (ModelParams,
                                                        build_tables,
                                                        device_tables)
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk
    from somatic_sniper_tpu_torch.pileup.prefilter import prefilter_tables
    from somatic_sniper_tpu_torch.utils.contract import diff_records, hist
    from somatic_sniper_tpu_torch.utils.stats import STATS

    params = ModelParams()
    tabs = build_tables(params)
    tumor, normal = str(pair / "tumor.bam"), str(pair / "normal.bam")
    fasta = FastaFile(str(pair / "ref.fa"))
    ref_blob, ref_off = runner._ref_blob(fasta, read_bam_header(tumor))
    gmin, margin = prefilter_tables(tabs)
    dtabs = device_tables(tabs, dev)
    t0 = time.perf_counter()
    header_t, pu_t, _, pu_n = runner._load_pileups(
        tumor, normal, params, (ref_blob, ref_off, tabs.fk, gmin, margin))
    refcache = runner.RefCache(fasta, header_t)
    drop_t, drop_n = runner._prefilter_flags(pu_t, pu_n, ref_blob, ref_off,
                                             tabs)
    t_load = time.perf_counter() - t0
    STATS.reset()
    gk.reset_launches()
    t1 = time.perf_counter()
    pending = runner.submit_batches(pu_t, pu_n, refcache, dtabs, dev,
                                    drop_t, drop_n, False, None,
                                    params.cap_mapq)
    recs = runner.collect_pending(pending, pu_t, pu_n, refcache, dtabs, dev,
                                  "vcf")
    t_score = time.perf_counter() - t1
    launches = dict(gk.LAUNCHES)
    stats = STATS.snapshot()
    print("  stage times of the batches:\n" + STATS.summary(), flush=True)
    lines = [ln.rstrip("\n") for _, ln in recs]
    tol = diff_records(lines, [ln for ln in exact_lines
                               if not ln.startswith("#")], "vcf")
    batches = int(stats.get("batches_dispatched", 0))
    dev_cols = int(stats.get("device_columns", 0))
    wall = t_load + t_score
    print(f"  batches {batches}, device columns {dev_cols}, output lines "
          f"{len(lines)}", flush=True)
    print(f"  wall {wall:.3f} s (load + prefilter {t_load:.3f} s, batches "
          f"{t_score:.3f} s), {n_cols / wall:.0f} cols/s of {n_cols}; "
          f"device columns {dev_cols / t_score:.0f} cols/s", flush=True)
    print(f"  launches {launches}", flush=True)
    print(f"  contract ok, hist {json.dumps(hist(tol), sort_keys=True)}",
          flush=True)
    if launches["accumulate"] < 2 * batches or launches["accumulate"] == 0:
        raise AssertionError(f"accumulate launched {launches['accumulate']} "
                             f"times for {batches} batches")
    return launches, stats


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
print(STATS.summary())
print(json.dumps({"launches": gk.LAUNCHES, "stats": STATS.snapshot()}))
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
    print(f"  fast without native: wall {wall:.3f} s (child process, "
          f"decode {stats.get('decode', 0):.3f} s), {n_cols / wall:.0f} "
          f"cols/s; native exact wall {exact_wall:.3f} s", flush=True)
    print(f"  launches {launches}", flush=True)
    print(f"  contract ok, hist {json.dumps(hist(tol), sort_keys=True)}",
          flush=True)
    if not (launches["accumulate16"] > 0 and launches["assembly10"] > 0
            and launches["accumulate32"] == 0):
        raise AssertionError(f"the no-native run did not take the u16 "
                             f"batch path: {launches}")
    return launches, stats


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
    from somatic_sniper_tpu_torch.runner import MAX_BATCH
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

    phase("3 kernels against their plain versions on the card")
    dtabs = device_tables(build_tables(ModelParams()), dev)
    errs = {name: 0.0 for name in KERNELS}
    fixed = {}  # (name, shape) -> timed() of phase 3
    for shapes, cases in ((SHAPES, slab_cases), (RANK_SHAPES, rank_cases)):
        for B, D in shapes:
            for name, case in cases(B, D, dtabs, dev, torch).items():
                t = fixed[name, (B, D)] = timed(name, (B, D), case, torch)
                errs[name] = max(errs[name], t[0])
    errs["accumulate"] = max(errs["accumulate"],
                             hazard_check(dtabs, dev, torch))
    for D in EDGE_DEPTHS:
        cases = rank_cases(EDGE_B, D, dtabs, dev, torch)
        if D <= 255:
            cases.update(slab_cases(EDGE_B, D, dtabs, dev, torch))
        for name, case in cases.items():
            errs[name] = max(errs[name], case[0])
        print(f"  edge depth B={EDGE_B} D={D:3d}: " + ", ".join(
            f"{name} equal (max_abs_err {case[0]:.3g})"
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
    for mode, ws in walls.items():
        print(f"  {mode:5s} wall " + ", ".join(
            f"{w:.3f} s ({n_cols / w:.0f} cols/s)" for w in ws), flush=True)
    print("  stage times of the second fast run:\n" + fast_summary,
          flush=True)
    for key in ("slabs_dispatched", "device_columns", "host_deep_columns",
                "host_tail_columns"):
        print(f"  {key} {int(stats.get(key, 0))}", flush=True)
    print(f"  slab depths {depths}, launches {launches}", flush=True)
    print(f"  contract ok, hist {json.dumps(hist(tol), sort_keys=True)}",
          flush=True)
    if int(stats.get("device_columns", 0)) <= 0:
        raise AssertionError("no column was scored on the device")
    if int(stats.get("host_tail_columns", 0)) != 0:
        raise AssertionError("the run's end was scored on the host")
    for name in ("accumulate32", "assembly10"):
        n = launches[name]
        if n < 2 * slabs or n == 0:
            raise AssertionError(
                f"{name} launched {n} times for {slabs} slabs")
    phase("5 golden pair, fast on the card")
    gold_out = out_dir / "golden_fast.vcf"
    run_cli(["--precision", "fast", "--device", "cuda", "-F", "vcf",
             "-f", str(GOLDEN / "small.fa"), str(GOLDEN / "t-small.bam"),
             str(GOLDEN / "n-small.bam"), str(gold_out)])
    gtol = diff_records(body_lines(gold_out),
                        body_lines(GOLDEN / "expected.vcf"), "vcf")
    print(f"  contract ok, hist {json.dumps(hist(gtol), sort_keys=True)}",
          flush=True)

    phase("6 batch path, full-u32 batches: 10 Mb pair, whole file")
    launches_u32, stats_u32 = u32_batches(
        pair, n_cols, body_lines(out_dir / "exact.vcf"), dev, torch)

    phase("7 CLI without the native library: 1 Mb pair, u16 batches")
    launches_u16, stats_u16 = cli_without_native(out_dir, torch)

    phase("8 kernels at the shapes the paths ran")
    # slabs are slab_b() columns; a batch holds at most max_batch
    # columns of one depth, so its largest is min(columns, max_batch)
    shapes = {
        "slab": path_shapes(stats, "slabs_at_depth_", lambda n: slab_b()),
        "u32": path_shapes(stats_u32, "batch_columns_at_depth_",
                           lambda n: min(n, MAX_BATCH)),
        "u16": path_shapes(stats_u16, "batch_columns_at_depth_",
                           lambda n: min(n, MAX_BATCH)),
    }
    print(f"  shapes, most-used first: {json.dumps(shapes)}", flush=True)
    at_path = kernels_at_path_shapes(shapes, dtabs, dev, torch)
    for (name, _), t in at_path.items():
        errs[name] = max(errs[name], t[0])

    # each kernel's launches from the phase that ran it, its times at
    # the main shape of its path (phase 8)
    runs = {
        "accumulate32": (launches, shapes["slab"][0]),
        "assembly10": (launches, shapes["slab"][0]),
        "accumulate": (launches_u32, shapes["u32"][0]),
        "accumulate16": (launches_u16, shapes["u16"][0]),
    }
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        counts, shape = runs[name]
        _, ms, pms, dms, pdms, bound, by = at_path[name, shape]
        # torch.profiler can come back empty this late in the process:
        # a device time it lost is taken from phase 3 where that timed
        # the same shape (same random lanes, same calls)
        early = fixed.get((name, shape))
        if early is not None:
            dms = early[3] if dms is None else dms
            pdms = early[4] if pdms is None else pdms
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by,
            # no one PyTorch call ranks reads within their classes or
            # assembles the ten genotype likelihoods
            "library_ms": None,
            "device_ms": dms, "plain_device_ms": pdms,
            "bound_share_of_device_ms": None if dms is None else bound / dms,
            "shape": list(shape),
        })
    print(f"  smoke wall {time.perf_counter() - t_start:.1f} s, set-up "
          "(both builds, the simulated pairs) included", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
