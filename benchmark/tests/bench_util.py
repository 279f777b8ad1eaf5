"""Shared helpers of the benchmark's CPU tests: a throwaway checkout
holding a copy of the benchmark, a tiny cell, and the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
PROGRAM = "somatic_sniper_tpu_torch"

# a 600 kb pair at 20x with many variants, so that sampled blocks hold
# records; -Q 15 as the tool's default
TINY = {
    "n_contigs": 2, "contig_len": 300_000, "read_len": 150,
    "tumor_depth": 20.0, "normal_depth": 20.0, "somatic_rate": 1e-3, "germline_rate": 1e-2,
    "error_rate": 0.005, "baseq_lo": 15, "baseq_hi": 40,
}


def make_root(tmp: Path, data: dict = TINY, flags=None) -> Path:
    """A checkout in ``tmp``: BENCHMARK.json with the cell ``tiny.passes``
    added, a copy of the benchmark, the program linked."""
    root = tmp / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / PROGRAM, root / PROGRAM)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "wgs30.json").read_text())
    cfg.update(name="tiny", data=dict(data))
    cfg["check"].update(blocks=4, block_bp=20_000)
    if flags is not None:
        cfg["flags"] = flags
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["workloads"].append(
        {"name": "tiny.passes", "config": "tiny", "traffic": "passes",
         "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws:
            ws += [w.replace("wgs30.", "tiny.") for w in ws
                   if w.startswith("wgs30.")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, workload: str, seed: int = 11, seconds: float = 2,
        trace: int = 0, prelude: str = "", timeout: float = 600):
    """Run the harness of ``root`` on the CPU in a fresh interpreter;
    ``prelude`` is Python run first (to break the program underneath).
    Returns (exit code, the result line as a dict or None, stderr)."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu"]
    code = (f"import sys, runpy\nsys.path.insert(0, {str(root)!r})\n"
            f"{prelude}\nsys.argv = ['run.py'] + {argv!r}\n"
            f"runpy.run_path({str(root / 'benchmark' / 'run.py')!r}, "
            "run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    last = p.stdout.strip().splitlines()[-1:] if p.stdout.strip() else []
    try:
        result = json.loads(last[0]) if last else None
    except json.JSONDecodeError:
        result = None
    return p.returncode, result, p.stderr
