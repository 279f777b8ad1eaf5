"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, so a failed phase exits non-zero and the
closing ``{"ok": true, ...}`` line is never printed):

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the CUDA kernels from ``somatic_sniper_tpu_torch/ops/csrc``;
3. each kernel against its plain torch version on the card, on random raw
   slabs at the slab shapes the main path uses, with the median time of
   20 timed calls of each;
4. the main path at a size users run: the port's CLI on a simulated
   10 Mb tumor/normal pair at 30x (windowed driver), fast precision on
   the card against exact precision (native host scoring) under the fast
   contract, with the launch counters proving the run went through both
   kernels;
5. fast precision on the card against the golden pair's expected VCF.

Its first statement makes ``import jax`` fail, so a pass also shows that
the port's main path never imports JAX; it imports only the port
(``somatic_sniper_tpu_torch``, whose ``host`` module hands it the
reference package's jax-free helpers).  The simulated pair is cached in
``chip_smoke_data/`` (gitignored) and regenerated when missing.
"""

import sys

sys.modules["jax"] = None  # any import of JAX from here on raises

import json  # noqa: E402
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
SIM = dict(n_contigs=2, contig_len=5_000_000, mean_depth=30.0, seed=11)
KERNELS = {
    "accumulate32": ("somatic_sniper_tpu_torch/ops/csrc/accumulate32.cu",
                     "somatic_sniper_tpu/ops/pallas_glfgen.py:578"),
    "assembly10": ("somatic_sniper_tpu_torch/ops/csrc/assembly10.cu",
                   "somatic_sniper_tpu/ops/pallas_glfgen.py:526"),
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
    """Device milliseconds per call from torch.profiler: the self device
    time of every kernel, copy and fill that TIMED_RUNS calls ran,
    divided by TIMED_RUNS.  None when the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED_RUNS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / TIMED_RUNS / 1e3 if us > 0 else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def kernels_vs_plain(torch, dev, dtabs) -> dict:
    """Phase 3: returns {(name, D): (max_abs_err, ms, plain_ms,
    device_ms, plain_device_ms)}."""
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    out = {}
    for B, D in SHAPES:
        s, nk, r = (torch.from_numpy(a).to(dev)
                    for a in random_slab_lanes(B, D, seed=D))
        w = dtabs.fk_weights
        k = gk.accumulate32(s, nk, r, w, 60)
        p = gk.accumulate32_plain(s, nk, r, w, 60)
        torch.cuda.synchronize()
        if not (torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])):
            raise AssertionError(f"accumulate32 c/rms differ at {(B, D)}")
        for a, b, what in ((k[0], p[0], "esum"), (k[1], p[1], "fsum")):
            if not torch.allclose(a, b, rtol=1e-6, atol=1e-5):
                raise AssertionError(
                    f"accumulate32 {what} outside rtol 1e-6, atol 1e-5 at "
                    f"{(B, D)}: max abs err {float((a - b).abs().max())}")
        acc_err = max(float((k[0] - p[0]).abs().max()),
                      float((k[1] - p[1]).abs().max()))
        coef_sub, lhet_sub = dtabs.assembly_tables(D)
        args = (k[0], k[1], k[2], nk, coef_sub, lhet_sub)
        lk, mlk = gk.assembly10(*args)
        lk_p, mlk_p = gk.assembly10_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)):
            raise AssertionError(f"assembly10 lk/min_lk differ at {(B, D)}")
        asm_err = float((lk - lk_p).abs().max())
        calls = {
            "accumulate32": (
                acc_err, lambda: gk.accumulate32(s, nk, r, w, 60),
                lambda: gk.accumulate32_plain(s, nk, r, w, 60)),
            "assembly10": (asm_err, lambda: gk.assembly10(*args),
                           lambda: gk.assembly10_plain(*args)),
        }
        for name, (err, kern, plain) in calls.items():
            out[name, D] = t = (err, call_ms(kern, torch),
                                call_ms(plain, torch),
                                device_ms(kern, torch),
                                device_ms(plain, torch))
            print(f"  {name:13s} B={B:5d} D={D:3d}  max_abs_err={err:.3g}  "
                  f"per call: kernel {t[1]:.4f} ms, plain {t[2]:.4f} ms; "
                  f"device: kernel {fmt_ms(t[3])}, plain {fmt_ms(t[4])}",
                  flush=True)
    return out


def ensure_pair() -> tuple[Path, int]:
    """The simulated 10 Mb pair, its BAM indexes, and its column count
    (tumor/normal pileup key intersection, the repo's bench definition).
    Set-up, not timed: the windowed driver would otherwise build the
    indexes inside the first timed run."""
    import numpy as np

    from somatic_sniper_tpu_torch.host import (SimConfig, bai, native_api,
                                               simulate_pair_fast)

    d = DATA / "pair_10mb"
    meta = d / "columns.json"
    if not meta.exists():
        t0 = time.perf_counter()
        simulate_pair_fast(d, SimConfig(**SIM))
        _, pu_t = native_api.load_and_columnize(str(d / "tumor.bam"))
        _, pu_n = native_api.load_and_columnize(str(d / "normal.bam"))
        n = len(np.intersect1d(pu_t.ukeys, pu_n.ukeys, assume_unique=True))
        meta.write_text(json.dumps({"columns": n, "sim": SIM}))
        print(f"  generated {d.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    for bam in ("tumor.bam", "normal.bam"):
        bai.ensure_index(d / bam)
    return d, json.loads(meta.read_text())["columns"]


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

    phase("1 card")
    card = card_line()
    print(card, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    from somatic_sniper_tpu_torch.device import resolve_device
    from somatic_sniper_tpu_torch.host import (STATS, ModelParams,
                                               build_tables, diff_records,
                                               hist)
    from somatic_sniper_tpu_torch.models.tables import device_tables
    from somatic_sniper_tpu_torch.ops import build
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    dev = resolve_device("cuda")
    phase("2 build")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    phase("3 kernels against their plain versions on the card")
    dtabs = device_tables(build_tables(ModelParams()), dev)
    timings = kernels_vs_plain(torch, dev, dtabs)

    phase("4 main path: 10 Mb pair at 30x, fast on the card vs exact")
    pair, n_cols = ensure_pair()
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
    for name, n in launches.items():
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

    # the kernels' times at the slab depth the main path ran (48 if it
    # ran at more than one depth)
    d_main = depths[0] if len(depths) == 1 else 48
    if ("accumulate32", d_main) not in timings:
        d_main = 48
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err = max(timings[name, D][0] for _, D in SHAPES)
        _, ms, pms, dms, pdms = timings[name, d_main]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "device_ms": dms, "plain_device_ms": pdms,
            "shape": [8192, d_main],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
