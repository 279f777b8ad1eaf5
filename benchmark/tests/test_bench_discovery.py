"""A later configuration, traffic mix and per-layer metric need only new
files and new entries: the harness finds each by its name."""

from __future__ import annotations

import hashlib
import json

from bench_util import TINY, make_root, run


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_by_files_alone(tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny2", data=dict(TINY, tumor_depth=12.0, normal_depth=12.0))
    (b / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    (b / "traffic" / "passes2.json").write_text(json.dumps(
        {"driver": "passes", "about": "a second mix"}))
    (b / "metrics" / "windows_per_s.py").write_text(
        '"""Genome windows finished a second."""\n\n\n'
        "def read(run):\n    return run.attempted / run.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny2.passes2", "config": "tiny2",
                               "traffic": "passes2", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "windows_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "columns_per_s",
                               "workloads": ["tiny2.passes2"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny.passes" in m["workloads"]:
            m["workloads"].append("tiny2.passes2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    rc, res, err = run(root, "tiny2.passes2", trace=0)
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["attempted"] >= 1
    assert {"columns_per_s", "setup_s", "peak_rss_gib"} <= set(res["metrics"])
    # the per-layer reader runs in the traced run; on the CPU the trace has
    # no device to read, so read it through the harness's reader directly
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "m", b / "metrics" / "windows_per_s.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class R:
        attempted, window_s = 10, 2.0
    assert mod.read(R) == 5.0
