"""Nothing the harness runs imports JAX or the JAX package; the check
compares whole top-level names (the port's own name begins with the JAX
package's)."""

from __future__ import annotations

import ast
import sys

from bench_util import HERE, make_root, run

sys.path.insert(0, str(HERE))


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_name_check():
    import run as harness

    ok = ["somatic_sniper_tpu_torch", "somatic_sniper_tpu_torch.runner",
          "jaxtyping", "benchmark_x", "numpy"]
    assert harness.forbidden_modules(ok) == []
    bad = ok + ["jax.numpy", "somatic_sniper_tpu.runner", "flax", "bench"]
    assert harness.forbidden_modules(bad) == [
        "bench", "flax", "jax", "somatic_sniper_tpu"]


def test_sources_import_neither_jax_nor_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "somatic_sniper_tpu", "bench"}
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(_top_imports(path))
        assert not names & bad, (path, names & bad)
        if "reference" in path.parts:   # the reference imports no program
            assert "somatic_sniper_tpu_torch" not in names, path


def test_a_run_loads_neither(tmp_path):
    root = make_root(tmp_path)
    rc, res, err = run(root, "tiny.passes",
                       prelude="import builtins\n"
                       "_imp = builtins.__import__\n"
                       "def _guard(name, *a, **k):\n"
                       "    if name.split('.')[0] in ('jax', 'somatic_sniper_tpu', 'flax', 'jaxlib'):\n"
                       "        raise ImportError('blocked: ' + name)\n"
                       "    return _imp(name, *a, **k)\n"
                       "builtins.__import__ = _guard\n")
    assert rc == 0 and res["correct"], err[-3000:]


def test_a_run_that_loads_jax_gives_no_result(tmp_path):
    root = make_root(tmp_path)
    rc, res, err = run(root, "tiny.passes",
                       prelude="import types; sys.modules['jax'] = types.ModuleType('jax')")
    assert rc != 0 and res is None
    assert "jax" in err
