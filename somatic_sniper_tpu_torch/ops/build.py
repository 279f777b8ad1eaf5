"""Build the CUDA kernels of ``ops/csrc`` with nvcc and bind them by ctypes.

The sources compile into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds rather than minutes),
written to ``ops/_build/`` under a name keyed by a hash of the sources
and the flags, and loaded once per process on first use.  Nothing is
built when the module is imported: the CPU-only test suite imports it.

Flags: ``-fmad=false`` keeps every multiply and add a separately rounded
IEEE operation, so the likelihood assembly reproduces its plain torch
version (and the JAX package's f32 op order) bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
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
    """Build output path, keyed by the sources' bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsniper_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=NVCC_TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {r.returncode}): {' '.join(cmd)}\n"
                f"{r.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sniper_accumulate32.argtypes = [p, p, p, p, p, p, p, p,
                                                i, i, i, p]
            lib.sniper_accumulate32.restype = i
            lib.sniper_assembly10.argtypes = [p, p, p, p, p, p, p, p, p,
                                              i, i, p]
            lib.sniper_assembly10.restype = i
            lib.sniper_cuda_error_string.argtypes = [i]
            lib.sniper_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
