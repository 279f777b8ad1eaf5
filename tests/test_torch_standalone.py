"""The torch port stands on its own: it imports neither JAX nor the JAX
package (``somatic_sniper_tpu``), statically or at run time.

(1) An ``ast`` walk over every module of the port and over
``chip_smoke.py`` finds no such import.  (2) A child process in which
both names are blocked imports every module of the port and runs its CLI
on the CPU: whole-file on the golden pair in exact precision (bytes
equal to the golden VCF) and in fast precision (within the fast
contract), and through the windowed driver on sim1.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_port_util import filtered_lines

from somatic_sniper_tpu.utils.contract import diff_records

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "somatic_sniper_tpu_torch"
BLOCKED = ("jax", "somatic_sniper_tpu")
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
BLOCK = "".join(f"sys.modules[{name!r}] = None\n" for name in BLOCKED)


def _is_blocked(module: str | None) -> bool:
    return module is not None and module.split(".")[0] in BLOCKED


def _blocked_imports(path: Path) -> list[str]:
    """Imports of a blocked package in one source file: import
    statements, ``__import__`` and ``importlib.import_module`` calls
    with a literal name."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            names = [node.args[0].value]
        else:
            continue
        found += [f"{path.name}:{node.lineno}: {n}" for n in names
                  if _is_blocked(n)]
    return found


def test_port_has_sources_to_walk():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "somatic_sniper_tpu_torch/runner.py",
            "somatic_sniper_tpu_torch/io/native_api.py",
            "somatic_sniper_tpu_torch/utils/stats.py"} <= names
    assert "somatic_sniper_tpu_torch/host.py" not in names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_import_of_jax_or_the_jax_package(path):
    assert _blocked_imports(path) == []


def _child(code: str, *argv: str, env=None):
    env = dict(os.environ if env is None else env)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-c", "import sys\n" + BLOCK + code, *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)


def test_every_module_imports_with_both_blocked():
    code = (
        "import importlib, importlib.util, pkgutil\n"
        "import somatic_sniper_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "# the built native library lies in a package directory: it is\n"
        "# loaded by ctypes, not imported\n"
        "names = [n for n in names\n"
        "         if importlib.util.find_spec(n).origin.endswith('.py')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'somatic_sniper_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    r = _child(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 30


CLI = ("from somatic_sniper_tpu_torch.cli.main import main\n"
       "sys.exit(main(sys.argv[1:]))\n")


@pytest.mark.parametrize("driver,precision", [
    ("whole", "exact"),
    ("whole", "fast"),
    ("windowed", "exact"),
    ("windowed", "fast"),
])
def test_cli_runs_with_both_blocked(data_dir, tmp_path, driver, precision):
    out = tmp_path / "alone.vcf"
    if driver == "whole":
        inputs = ["-f", str(data_dir / "small.fa"),
                  str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam")]
        want = data_dir / "expected.vcf"
    else:
        d = data_dir / "e2e" / "sim1"
        inputs = ["--shard-index", "0", "--window-size", "700",
                  "-f", str(d / "ref.fa"), str(d / "tumor.bam"),
                  str(d / "normal.bam")]
        want = d / "expected.vcf"
    r = _child(CLI, "--device", "cpu", "--precision", precision, "-F", "vcf",
               *inputs, str(out))
    assert r.returncode == 0, r.stderr
    if precision == "exact":
        assert filtered_lines(out) == filtered_lines(want)
    else:
        diff_records(filtered_lines(out), filtered_lines(want), "vcf")


def test_profile_env_writes_a_torch_trace(data_dir, tmp_path):
    """SNIPER_PROFILE: the port's CLI records the whole-file run with
    torch.profiler where the JAX CLI starts a JAX trace."""
    trace_dir = tmp_path / "trace"
    env = dict(os.environ, SNIPER_PROFILE=str(trace_dir))
    r = _child(CLI, "--device", "cpu", "--precision", "fast", "-F", "vcf",
               "-f", str(data_dir / "small.fa"),
               str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
               str(tmp_path / "p.vcf"), env=env)
    assert r.returncode == 0, r.stderr
    assert (trace_dir / "trace.json").stat().st_size > 0
    diff_records(filtered_lines(tmp_path / "p.vcf"),
                 filtered_lines(data_dir / "expected.vcf"), "vcf")
