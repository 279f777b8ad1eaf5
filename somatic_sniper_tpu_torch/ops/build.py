"""Build the CUDA kernels of ``ops/csrc`` with nvcc and bind them by ctypes.

Each ``csrc/*.cu`` compiles to an object with its own nvcc, all started
together, and the objects link into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds rather than
minutes), written to ``ops/_build/`` under a name keyed by a hash of the
sources, the headers and the flags, and loaded once per process on
first use.  Nothing is built when the module is imported: the CPU-only
test suite imports it.

Flags: ``-fmad=false`` keeps every multiply and add a separately rounded
IEEE operation, so the likelihood assembly reproduces its plain torch
version (and the JAX package's f32 op order) bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..utils.stats import STATS

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default install location; raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of "
        "somatic_sniper_tpu_torch are built from source at first use "
        "and need the CUDA toolkit"
    )


def library_path() -> Path:
    """Build output path, keyed by the sources' and headers' bytes and
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsniper_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; raise if any fails, else return what
    each wrote to its standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed, errs = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            errs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): "
                              f"{' '.join(cmd)}\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def _compile(nvcc: str, tmp: Path,
             extra: tuple[str, ...] = ()) -> tuple[list[Path], list[str]]:
    """One nvcc per source, all started together, objects into ``tmp``;
    returns (objects, each compiler's standard error)."""
    objs = [tmp / f"{src.stem}.o" for src in sources()]
    errs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(o), str(src)]
                     for src, o in zip(sources(), objs)])
    return objs, errs


def build() -> Path:
    """Compile the kernels unless this exact build already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename the library into place:
    # a concurrent process never loads a half-written one
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs, _ = _compile(nvcc, tmp)
        lib = tmp / "lib.so"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _kernel_of(mangled: str) -> str | None:
    """``name`` or ``name<v,...>`` (``score_columns_kernel<0,1>``) of
    the ``*_kernel`` function a mangled symbol names: the Itanium
    encoding writes an identifier as its length, then its characters,
    and its template arguments as ``I...E`` of literals
    ``L<type><value>E`` (``Li64E`` the int 64, ``Lin1E`` the int -1,
    ``Lb1E`` the bool true)."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            n = int(mangled[start:m.end()])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel") \
                    and name.isidentifier():
                args = re.match(r"I((?:L[a-z]n?\d+E)+)E",
                                mangled[m.end() + n:])
                if not args:
                    return name
                values = [v.replace("n", "-") for v in
                          re.findall(r"L[a-z](n?\d+)E", args[1])]
                return f"{name}<{','.join(values)}>"
    return None


def resource_usage() -> dict[str, dict[str, int]]:
    """{kernel: {"registers", "spill_bytes", "smem_bytes"}} as
    ``nvcc -Xptxas -v`` reports them with the build's flags; compiles
    every source again (a few seconds), keeping nothing."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        _, errs = _compile(nvcc, tmp, ("-Xptxas", "-v"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    usage: dict[str, dict[str, int]] = {}
    kernel = None
    for line in "\n".join(errs).splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            kernel = _kernel_of(m[1])
        elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage.setdefault(kernel, {})["spill_bytes"] = int(m[1])
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            usage.setdefault(kernel, {}).update(
                registers=int(m[1]), smem_bytes=int(smem[1]) if smem else 0)
    return usage


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# Every extern "C" function of csrc/, with its argument and result types
# in the order of its C signature.  ctypes checks neither: a pointer bound
# as an int is cut to 32 bits and a wrong count shifts every later
# argument, so tests/test_torch_fused.py holds this table to the sources.
SIGNATURES: dict[str, tuple[list, object]] = {
    # slots, n_keep, ref16, weights, esum, fsum, c, rms, B, D, cap_mapq,
    # stream
    "sniper_accumulate32": ([_P] * 8 + [_I, _I, _I, _P], _I),
    # slots, n_keep, ref16, weights, coef_sub, lhet_sub, lk, min_lk, rms,
    # B, D, NK, cap_mapq, stream
    "sniper_glfgen32": ([_P] * 9 + [_I, _I, _I, _I, _P], _I),
    # esum, fsum, c, n, coef_sub, lhet_sub, lk, min_lk, err, B, NK, stream
    "sniper_assembly10": ([_P] * 9 + [_I, _I, _P], _I),
    # slots, depth, ref16, weights, esum, fsum, c, rms, n, scratch,
    # scratch_ints, B, D, cap_mapq, stream
    "sniper_accumulate": ([_P] * 10 + [_LL, _I, _I, _I, _P], _I),
    # slots, depth, ref16, weights, coef_sub, lhet_sub, lk, min_lk, rms, n,
    # B, D, NK, cap_mapq, stream
    "sniper_glfgen": ([_P] * 10 + [_I, _I, _I, _I, _P], _I),
    # slots16, n_keep, weights, esum, fsum, c, scratch, scratch_ints, B, D,
    # stream
    "sniper_accumulate16": ([_P] * 7 + [_LL, _I, _I, _P], _I),
    # slots16, n_keep, weights, coef_sub, lhet_sub, lk, min_lk, B, D, NK,
    # stream
    "sniper_glfgen16": ([_P] * 7 + [_I, _I, _I, _P], _I),
    # lk_t, lk_n, depth_t, depth_n, n_t, n_n, ref16, solo_prior,
    # joint_prior, slots_t, slots_n, nk_t, nk_n, emit, fields, dq_t, dq_n,
    # B, D, q_r_int, use_joint, min_somatic_qual, include_loh, include_gor,
    # stream
    "sniper_score_columns": ([_P] * 17 + [_I] * 7 + [_P], _I),
    # B, D
    "sniper_rank_scratch_ints": ([_I, _I], _LL),
    # blocks, threads, stream
    "sniper_empty_launch": ([_I, _I, _P], _I),
    # code
    "sniper_cuda_error_string": ([_I], ctypes.c_char_p),
    # device, comp, comp_len, n_blocks, in_off, in_len, isize, crc, out,
    # out_off, status
    "sniper_card_inflate": ([_I, _P, _LL, _I] + [_P] * 7, _I),
    # (none)
    "sniper_bgzf_inflate_launches": ([], _LL),
    # device, bytes, n_bytes, rec, n_reads, tid, lo, hi, max_len, ref,
    # n_ref, fk, gmin, margin, fused, out, counts
    "sniper_card_pileup": ([_I, _P, _LL, _P, _I, _I, _LL, _LL, _LL, _P, _LL,
                            _P, _P, ctypes.c_double, _I, _P, _P], _I),
    # buffer
    "sniper_card_pileup_release": ([_P], None),
    # (none)
    "sniper_pileup_card_launches": ([], _LL),
}

_card_counted = False


def _count_card_launches(lib) -> None:
    """From the first card hand-off on, ``STATS`` counts the inflate's
    launches as ``launches_bgzf_inflate`` and the pileup builds' as
    ``launches_pileup_card``."""
    global _card_counted
    with _lock:
        if not _card_counted:
            STATS.add_source(lambda: ({}, {
                "launches_bgzf_inflate": lib.sniper_bgzf_inflate_launches(),
                "launches_pileup_card": lib.sniper_pileup_card_launches()}))
            _card_counted = True


def card_inflate_address() -> int:
    """Address of ``sniper_card_inflate``, for the native loader's
    ``sniper_set_card_inflate``; builds the library on first use."""
    lib = load_library()
    _count_card_launches(lib)
    return ctypes.cast(lib.sniper_card_inflate, ctypes.c_void_p).value


def card_pileup_addresses() -> tuple[int, int]:
    """Addresses of ``sniper_card_pileup`` and
    ``sniper_card_pileup_release``, for the native loader's
    ``sniper_set_card_pileup``; builds the library on first use."""
    lib = load_library()
    _count_card_launches(lib)
    return tuple(ctypes.cast(fn, ctypes.c_void_p).value for fn in (
        lib.sniper_card_pileup, lib.sniper_card_pileup_release))


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
