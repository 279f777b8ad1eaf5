"""Faults planted under the timed path, for reading the check against
them: a run with one of them must come out not correct.

    python3 benchmark/faults.py --fault half_left_out -- \\
        --workload wgs30.passes --seed 7 --seconds 10 --trace 0

runs ``run.py`` with the arguments after ``--`` in this process, the
program's windowed driver wrapped so that each window's records pass
through the fault.  The CPU tests (``tests/test_bench_faults.py``) plant
the same faults at a test's size.
"""

from __future__ import annotations

import argparse
import runpy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

WRAP = """
from somatic_sniper_tpu_torch.parallel import sharded
_orig = sharded.call_pair_windows
def _broken(*a, **k):
    for wi, win, lines in _orig(*a, **k):
        yield wi, win, FAULT(wi, lines)
sharded.call_pair_windows = _broken
"""

FAULTS = {
    # one token of every record: the tumor's depth one higher
    "altered": "def FAULT(wi, lines):\n"
               "    out = []\n"
               "    for ln in lines:\n"
               "        f = ln.split('\\t'); s = f[10].split(':')\n"
               "        s[2] = str(int(s[2]) + 1); f[10] = ':'.join(s)\n"
               "        out.append('\\t'.join(f))\n"
               "    return out\n",
    # every other window's records left out
    "half_left_out": "def FAULT(wi, lines):\n"
                     "    return lines if wi % 2 == 0 else []\n",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cut = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    a = ap.parse_args(argv[:cut])
    sys.path.insert(0, str(HERE.parent))
    exec(FAULTS[a.fault] + WRAP, {})
    sys.argv = [str(HERE / "run.py")] + argv[cut + 1:]
    runpy.run_path(str(HERE / "run.py"), run_name="__main__")


if __name__ == "__main__":
    main()
