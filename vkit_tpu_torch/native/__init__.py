"""Native (C++) host kernels, loaded via ctypes.

Counterpart of vkit_tpu/native: the same ``geometry.cpp``, built with the
same g++ flags so both packages compute the same numbers.  The library
builds at first use into ``native/build/`` under a name that hashes the
source and the flags; the build writes a temporary file and renames it into
place, so a process never loads a half-written library that another process
is still writing.  Any failure falls back to the pure-python
implementations in geometry/_numpy_impl.py.
"""
import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / 'geometry.cpp'
_BUILD = Path(__file__).resolve().parent / 'build'
_GXX_FLAGS = (
    '-O3', '-march=native', '-ffp-contract=off', '-funroll-loops',
    '-shared', '-fPIC',
)

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(' '.join(_GXX_FLAGS).encode())
    return _BUILD / f'libvkitgeom_{digest.hexdigest()[:16]}.so'


def _build(target: Path) -> bool:
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ['g++', *_GXX_FLAGS, str(_SRC), '-o', str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)
        return True
    except Exception:  # noqa: BLE001
        logger.exception('native geometry build failed; using numpy fallback')
        tmp.unlink(missing_ok=True)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if missing) and load the geometry library; None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if not target.exists() and not _build(target):
        return None
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        logger.exception('native geometry load failed; using numpy fallback')
        return None

    lib.vg_fill_poly.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vg_fill_poly.restype = None
    lib.vg_label8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vg_label8.restype = ctypes.c_int
    lib.vg_trace_boundary.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
    ]
    lib.vg_trace_boundary.restype = ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vg_remap_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p,
    ]
    lib.vg_remap_f32.restype = None
    lib.vg_resize_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, f32p, ctypes.c_int, ctypes.c_int,
        i32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p,
    ]
    lib.vg_resize_f32.restype = None
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vg_lattice_node_maps.argtypes = [
        f64p, f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, ctypes.c_int, i32p, ctypes.c_int,
        f32p, f32p, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vg_lattice_node_maps.restype = None
    lib.vg_cell_mats.argtypes = [
        f64p, f64p, ctypes.c_int,
        f64p, f64p, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vg_cell_mats.restype = None
    lib.vg_repair_backward_maps.argtypes = [
        f64p, f64p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.vg_repair_backward_maps.restype = None

    _lib = lib
    return lib
