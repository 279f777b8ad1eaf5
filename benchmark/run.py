#!/usr/bin/env python3
"""Benchmark of somatic_sniper_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload wgs30.passes --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  The cell (``workloads`` of
BENCHMARK.json) names a configuration (``benchmark/configs/<name>.json``:
flags, precision, the pair's sizes, the check's sample) and a traffic mix
(``benchmark/traffic/<name>.json``: which driver); every metric is read
by ``benchmark/metrics/<name>.py``.  Set-up makes the pair from
``--seed`` (``pairgen``), imports the program and runs one warm-up pass;
the window then runs the traffic for ``--seconds``; after it, the
program's records are compared with the plain reference (``reference/``)
by ``check``.  The last line of standard output is the
result as JSON; with ``--trace 1`` the metrics are the cell's per-layer
ones, read from a torch.profiler trace and the program's ``STATS``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "somatic_sniper_tpu", "bench")
KEY_BITS = 40           # a column's key: contig index << KEY_BITS | position


class Refused(SystemExit):
    """The run cannot give a result: message on stderr, exit code 1."""

    def __init__(self, msg: str):
        print(f"benchmark: {msg}", file=sys.stderr)
        super().__init__(1)


def load_cell(root: Path, name: str):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    here = root / "benchmark"
    config = json.loads((here / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(here: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def work_dir(root: Path) -> Path:
    """Fixed scratch of the benchmark inside the checkout (.gitignore)."""
    w = root / "_benchwork"
    w.mkdir(exist_ok=True)
    return w


def chip_check(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"needs {chips}")


def forbidden_modules(names=None) -> list:
    """Top-level names, compared whole, of JAX and the JAX package among
    ``names`` (the loaded modules by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Nvml:
    """The card's power limit, read through NVML."""

    def __init__(self):
        import ctypes

        self.lib = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            if lib.nvmlInit_v2() == 0:
                self.h = ctypes.c_void_p()
                if lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(self.h)) == 0:
                    self.lib = lib
        except OSError:
            pass

    def power_limit_w(self):
        import ctypes

        v = ctypes.c_uint()
        if self.lib is None or self.lib.nvmlDeviceGetPowerManagementLimit(
                self.h, ctypes.byref(v)):
            return None
        return v.value / 1000.0


class Sampler:
    """Samples a reading in a thread at ``hz`` and keeps its peak."""

    def __init__(self, fn, hz: float):
        self.fn, self.dt, self.peak = fn, 1.0 / hz, 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while True:
            self.peak = max(self.peak, self.fn())
            if self._stop.wait(self.dt):
                return

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self.fn())


def rss_bytes() -> int:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def program_params(flags: list):
    """The CLI's parser and its ModelParams mapping (cli/main.py) applied
    to the cell's flags."""
    from somatic_sniper_tpu_torch.cli.main import build_parser
    from somatic_sniper_tpu_torch.models.tables import ModelParams

    a = build_parser().parse_args(list(flags) + ["-f", "ref", "t", "n", "out"])
    return a, ModelParams(
        theta=a.theta, n_hap=a.n_hap, het_rate=a.het_rate,
        use_priors=not a.no_priors,
        use_joint_priors=a.joint or a.somatic_rate is not None,
        somatic_mutation_rate=(a.somatic_rate if a.somatic_rate is not None
                               else 0.01),
        min_somatic_qual=a.min_somatic_qual, include_loh=not a.no_loh,
        include_gor=not a.no_gor, mapq_threshold=a.mapq)


def genome_windows(lengths, size):
    """parallel/sharded.genome_windows."""
    return [(t, b, min(b + size, ln)) for t, ln in enumerate(lengths)
            for b in range(0, ln, size)]


def sample_blocks(spans, blocks: int, block_bp: int, seed: int):
    """``blocks`` disjoint blocks of ``block_bp`` positions drawn from the
    seed inside the windows ``spans``, sorted."""
    import numpy as np

    slots = [(t, b) for t, beg, end in spans
             for b in range(beg, end - block_bp + 1, block_bp)]
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 99]))
    pick = rng.choice(len(slots), size=min(blocks, len(slots)), replace=False)
    return sorted((slots[i][0], slots[i][1], slots[i][1] + block_bp) for i in pick)


def check_sample(spans, chk: dict, seed: int, sites):
    """What the check reads in full: ``chk["blocks"]`` blocks of
    ``chk["block_bp"]`` positions drawn from the seed, and every planted
    somatic site (``sites``: (contig index, position)) inside ``spans``.
    Returns (the regions, sorted and disjoint; ``in_sample(key)``)."""
    import numpy as np

    blocks = sample_blocks(spans, chk["blocks"], chk["block_bp"], seed)
    bkeys = np.array([(t << KEY_BITS) | b for t, b, _ in blocks], np.int64)
    ekeys = np.array([(t << KEY_BITS) | e for t, _, e in blocks], np.int64)

    def in_blocks(k):
        i = np.searchsorted(bkeys, k, side="right") - 1
        return bool(i >= 0 and k < ekeys[i])

    points = {(t << KEY_BITS) | p for t, p in sites
              if any(s == t and b <= p < e for s, b, e in spans)}
    points = {k for k in points if not in_blocks(k)}
    mask = (1 << KEY_BITS) - 1
    regions = sorted(blocks + [(k >> KEY_BITS, k & mask, (k & mask) + 1)
                               for k in points])
    return regions, lambda k: k in points or in_blocks(k)


@contextmanager
def host_spans(stats, on: bool):
    """Record each ``STATS.timer`` stage as (stage, t0_ns, t1_ns) while
    ``on``; the program's totals are kept as they are."""
    spans = []
    if not on:
        yield spans
        return
    timer = stats.timer

    @contextmanager
    def recording(stage):
        t = time.perf_counter_ns()
        try:
            with timer(stage):
                yield
        finally:
            spans.append((stage, t, time.perf_counter_ns()))

    stats.timer = recording
    try:
        yield spans
    finally:
        del stats.timer


def run_passes(ctx, deadline):
    """One whole-pair pass; stops after the first window finished at or
    past ``deadline``.  Returns (windows finished, lines, complete)."""
    from somatic_sniper_tpu_torch.parallel import sharded

    done, lines = [], []
    gen = sharded.call_pair_windows(
        str(ctx.pair.tumor), str(ctx.pair.normal), str(ctx.pair.ref),
        fmt="vcf", params=ctx.params, precision=ctx.precision,
        window_size=ctx.window_size, device=ctx.device)
    complete = True
    try:
        for wi, _win, ls in gen:
            done.append((wi, hashlib.md5("".join(ls).encode()).hexdigest()))
            lines.extend(ls)
            if deadline is not None and time.perf_counter() >= deadline:
                complete = False
                break
    finally:
        gen.close()
    return done, lines, complete


def drive_passes(ctx, seconds, trace):
    import torch

    from somatic_sniper_tpu_torch.utils.stats import STATS

    t = time.perf_counter()
    warm, ctx.lines, _ = run_passes(ctx, None)
    ctx.info.update(warmup_s=time.perf_counter() - t, rss_after_warmup=rss_bytes())
    ref_hash = dict(warm)
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize(ctx.device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if ctx.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    ctx.setup_s = time.perf_counter() - T0
    before = STATS.snapshot()
    columns = ctx.pair.window_columns(ctx.window_size)
    passes = windows = differing = 0
    with host_spans(STATS, trace) as spans, Sampler(rss_bytes, 20) as rss:
        if trace:
            t_align = time.perf_counter_ns()
            with record_function("bench.align"):
                pass
        t_start = time.perf_counter()
        cpu0 = time.process_time()
        deadline = t_start + seconds
        n_cols = 0
        pass_s = []
        while True:
            t = time.perf_counter()
            done, lines, complete = run_passes(ctx, deadline)
            t_end = time.perf_counter()
            pass_s.append(round(t_end - t, 3))
            windows += len(done)
            n_cols += sum(columns[wi] for wi, _ in done)
            differing += sum(h != ref_hash.get(wi) for wi, h in done)
            if complete:
                passes += 1
                ctx.lines = lines
            if not complete or t_end >= deadline:
                break
    ctx.window_s = t_end - t_start
    ctx.cpu_s = time.process_time() - cpu0
    ctx.info.update(pass_s=pass_s, cpu_s=ctx.cpu_s)
    ctx.stats = {k: v - before.get(k, 0) for k, v in STATS.snapshot().items()}
    ctx.columns, ctx.passes, ctx.attempted = n_cols, passes, windows
    ctx.differing, ctx.failed = differing, 0
    ctx.info.update(passes=passes)
    ctx.rss_peak = rss.peak
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize(ctx.device)
        ctx.memory_peak = torch.cuda.max_memory_allocated(ctx.device)
    if prof is not None:
        prof.__exit__(None, None, None)
        path = ctx.work / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        read_trace(ctx, path, t_align, t_start, t_end, spans)
        path.unlink()


def read_trace(ctx, path, t_align, t0, t1, spans):
    """Device busy time and breakdown of the traced window [t0, t1)
    (host seconds); ``t_align``: the host's ns at the trace's marker."""
    import devtrace

    ev = devtrace.load(path)
    at = devtrace.find_ts(ev, "bench.align")
    if at is None:
        raise RuntimeError("the trace lacks the alignment marker")
    off = at - t_align / 1e3
    s = devtrace.summarize(ev, t0 * 1e6 + off, t1 * 1e6 + off,
                           [(n, a / 1e3 + off, b / 1e3 + off) for n, a, b in spans])
    ctx.busy_s, ctx.device_op_s, ctx.device_ops = s["busy_s"], s["op_s"], int(s["ops"])
    ctx.breakdown = {
        "device_ops": sorted(([k, v] for k, v in s["device_ops"]), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(s["idle_gaps"], key=lambda g: -g[1])[:10],
    }


DRIVERS = {"passes": drive_passes}


def _make_pair(conn, outdir, data, seed):
    import pairgen

    conn.send(pairgen.generate(outdir, data, seed))
    conn.close()


def make_pair(outdir, data, seed):
    """The pair of ``seed``, made by a spawned child (with its own pool)
    so that none of the making stays resident in this process."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    p = ctx.Process(target=_make_pair, args=(send, outdir, data, seed))
    p.start()
    send.close()
    try:
        pair = recv.recv()
    except EOFError:
        pair = None
    p.join()
    if p.exitcode != 0 or pair is None:
        raise RuntimeError(f"making the pair failed (exit {p.exitcode})")
    return pair


def correctness(ctx):
    """Reference over the check's sample and every emitted column."""
    import check
    from reference import caller, model

    chk = ctx.config["check"]
    sample, in_sample = check_sample(ctx.spans, chk, ctx.seed, ctx.pair.somatic)
    tid_of = {n: i for i, n in enumerate(ctx.ref_names)}
    cols = set()
    for ln in ctx.lines:
        try:
            k = check.line_key(ln, tid_of)
        except (KeyError, ValueError, IndexError):
            continue
        if not in_sample(k):
            cols.add((k >> KEY_BITS, k & ((1 << KEY_BITS) - 1)))
    regions = sorted(set(sample) | {(t, p, p + 1) for t, p in cols})
    prm = model.params_from_flags(ctx.flags)
    tol = chk["phred_tolerance"]
    ref = caller.call(ctx.pair.tumor, ctx.pair.normal, ctx.pair.ref, prm,
                      regions=regions, tol=tol)
    got = check.compare(ctx.lines, ref, in_sample, tid_of, prm.min_qual, tol)
    got["reference_s"] = ref.seconds
    got["columns_compared"] = ref.columns
    got["columns_scored"] = ref.scored
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the CPU tests' way past the look for a card; never given on a card
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    root, device = ROOT, a.device
    work = work_dir(root)
    # kernel caches at fixed paths inside the checkout (the program keeps
    # its own under its package: ops/_build, io/native)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(work / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(work / "triton")
    bench, cell, config, traffic = load_cell(root, a.workload)
    if traffic["driver"] not in DRIVERS:
        raise Refused(f"no traffic driver {traffic['driver']!r}")
    if device == "cuda":
        chip_check(int(cell["chips"]))
    rss = {"after_chip_check": rss_bytes()}
    for p in (str(HERE), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    t = time.perf_counter()
    pair = make_pair(work / "data", config["data"], a.seed)
    gen_s = time.perf_counter() - t
    flags = list(config["flags"])
    import torch  # set-up: the program's first import of torch

    args, params = program_params(flags)
    rss["after_imports"] = rss_bytes()
    ctx = SimpleNamespace(
        seed=a.seed, work=work, pair=pair, config=config, traffic=traffic,
        flags=flags, params=params, precision=config["precision"],
        device=device, window_size=int(args.window_size),
        ref_names=[f"ctg{i + 1}" for i in range(config["data"]["n_contigs"])],
        ref_lengths=[config["data"]["contig_len"]] * config["data"]["n_contigs"],
        busy_s=None, breakdown=None, rss_peak=None, memory_peak=0, info={})
    ctx.spans = genome_windows(ctx.ref_lengths, ctx.window_size)
    DRIVERS[traffic["driver"]](ctx, a.seconds, bool(a.trace))
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package loaded: {found}")
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    got = correctness(ctx)
    limits = dict(config["check"]["limits"])
    values = {"records_off": got["records_off"], "loose_pct": got["loose_pct"],
              "passes_differing": ctx.differing}
    correct = all(values[k] <= limits[k] for k in limits) and not ctx.failed
    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(a.trace)):
        v = reader(HERE, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    nvml = Nvml()
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(ctx.memory_peak)}
    out = {"correct": bool(correct), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics, "device": dev,
           "card": {"power_limit_w": nvml.power_limit_w()},
           "info": {k: got[k] for k in got if k not in limits}}
    out["info"].update(pair_s=gen_s, window_s=ctx.window_s,
                       mean_depth=pair.mean_depth, **ctx.info,
                       **{f"rss_{k}": v for k, v in rss.items()})
    if a.trace:
        if not ctx.busy_s or ctx.busy_s <= 0:
            raise Refused("the trace shows no device activity in the window")
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s
        out["breakdown"] = ctx.breakdown
    out["check"] = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    for k, v in out["info"].items():
        print(f"info {k} {v}", file=sys.stderr)
    print(f"card {dev['kind']} power_limit_w {out['card']['power_limit_w']}",
          file=sys.stderr)
    for k in limits:
        print(f"check {k} {values[k]} limit {limits[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
