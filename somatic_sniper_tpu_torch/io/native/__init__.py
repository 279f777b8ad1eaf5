"""ctypes loader for the native IO/pileup library.

Builds ``libsniper_native.so`` from sniper_native.cpp on first use (g++
-O3, links zlib).  Falls back gracefully: callers check ``available()``
and use the pure-Python path when the toolchain is missing.

Copy of somatic_sniper_tpu/io/native/__init__.py, with the port's own copy
of ``sniper_native.cpp`` beside it: the port keeps its own host layer and
imports nothing of the JAX package.  The library is built at first use
into this directory (a rename puts it in place).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "sniper_native.cpp"
_LIB = _DIR / "libsniper_native.so"
_lock = threading.Lock()
_lib = None
_tried = False


class NativeBamHeaderStruct(ctypes.Structure):
    _fields_ = [
        ("text", ctypes.c_char_p),
        ("n_ref", ctypes.c_int32),
        ("ref_len", ctypes.POINTER(ctypes.c_int32)),
        ("ref_names", ctypes.POINTER(ctypes.c_char)),
        ("ref_names_len", ctypes.c_int64),
        ("_storage", ctypes.c_void_p),
    ]


class NativeRecTableStruct(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("end_voff", ctypes.c_int64),
        ("voff", ctypes.POINTER(ctypes.c_int64)),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("end", ctypes.POINTER(ctypes.c_int64)),
        ("_storage", ctypes.c_void_p),
    ]


class NativePileupStruct(ctypes.Structure):
    _fields_ = [
        ("n_entries", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("keys", ctypes.POINTER(ctypes.c_int64)),
        ("slots", ctypes.POINTER(ctypes.c_uint32)),
        ("ukeys", ctypes.POINTER(ctypes.c_int64)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("pure", ctypes.POINTER(ctypes.c_uint8)),
        ("_storage", ctypes.c_void_p),
    ]


def _build() -> bool:
    # built beside the target and renamed into place, so a process that
    # loads the library while another one builds it never maps half a file
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread", "-o", str(tmp), str(_SRC), "-lz"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired, OSError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def get_lib():
    """Load (building if needed) the native library, or None.

    ``SNIPER_NATIVE_LIB`` points at an alternative prebuilt .so — the
    ASAN e2e suite uses it to run the whole CLI matrix against an
    address-sanitized build of this same source (the reference wraps
    every integration run in valgrind; reference
    build-common/python/valgrindwrapper.py)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        override = os.environ.get("SNIPER_NATIVE_LIB")
        lib_path = Path(override) if override else _LIB
        if not override and (
            not _LIB.exists()
            or _LIB.stat().st_mtime < _SRC.stat().st_mtime
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        # (the two-phase bam_load/pileup_build C entries still exist for
        # the ASAN driver and as parity oracles, but the Python layer
        # only uses the fused loads below)
        lib.pileup_destroy.argtypes = [ctypes.POINTER(NativePileupStruct)]
        _flag_tail = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
        ]
        lib.region_last_kept_start.restype = ctypes.c_int64
        lib.region_last_kept_start.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.pileup_pad.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.pileup_pad16.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.slab_fill_pair.restype = None
        lib.slab_fill_pair.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pileup_flags.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.paired_plan.restype = ctypes.c_int64
        lib.paired_plan.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pileup_dqstats.restype = None
        lib.pileup_dqstats.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.glf_cns_batch.restype = None
        lib.glf_cns_batch.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.glf_cns_proof_batch.restype = None
        lib.glf_cns_proof_batch.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.exact_pair_rows.restype = ctypes.c_int64
        lib.exact_pair_rows.argtypes = [
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(NativePileupStruct),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bam_read_header.restype = ctypes.POINTER(NativeBamHeaderStruct)
        lib.bam_read_header.argtypes = [ctypes.c_char_p]
        lib.bam_header_destroy.argtypes = [
            ctypes.POINTER(NativeBamHeaderStruct)
        ]
        lib.bam_load_pileup.restype = ctypes.POINTER(NativePileupStruct)
        lib.bam_load_pileup.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ] + _flag_tail
        lib.bam_load_region_pileup.restype = ctypes.POINTER(
            NativePileupStruct
        )
        lib.bam_load_region_pileup.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ] + _flag_tail
        lib.bam_record_table.restype = ctypes.POINTER(NativeRecTableStruct)
        lib.bam_record_table.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.rec_table_destroy.argtypes = [
            ctypes.POINTER(NativeRecTableStruct)
        ]
        lib.emit_lines.restype = ctypes.c_int64
        lib.emit_lines.argtypes = [
            ctypes.c_int32, ctypes.c_int64,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sniper_prof.restype = None
        lib.sniper_prof.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.sniper_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _as_np(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).view(dtype)
