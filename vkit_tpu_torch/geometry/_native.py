"""ctypes bridge to the C++ geometry kernels (vkit_tpu/native/geometry.cpp).

Bit-exact with _numpy_impl (fill_poly, external_contours,
disconnected_components); raises ImportError if the native library is
unavailable so geometry/__init__ falls back transparently.
"""
import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from ..native import load_library

_lib = load_library()
if _lib is None:
    raise ImportError('native geometry library unavailable')

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def fill_poly(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    height, width = shape
    mask = np.zeros((height, width), dtype=np.uint8)
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
    if len(pts) < 2 or height <= 0 or width <= 0:
        return mask
    _lib.vg_fill_poly(
        pts.ctypes.data_as(_F64P), len(pts),
        height, width, mask.ctypes.data_as(_U8P),
    )
    return mask


def _label8(np_mask: np.ndarray) -> Tuple[np.ndarray, int]:
    np_mask = np.ascontiguousarray(np_mask.astype(np.uint8, copy=False))
    height, width = np_mask.shape
    labels = np.empty((height, width), dtype=np.int32)
    num = _lib.vg_label8(
        np_mask.ctypes.data_as(_U8P), height, width,
        labels.ctypes.data_as(_I32P),
    )
    return labels, num


def _first_occurrences(labels: np.ndarray, num: int) -> np.ndarray:
    flat = labels.ravel()
    nz = np.flatnonzero(flat)
    labs = flat[nz]
    _, first_idx = np.unique(labs, return_index=True)
    return nz[first_idx]  # labels are 1..num in raster order already


def _trace(labels: np.ndarray, comp: int, sy: int, sx: int,
           buf: np.ndarray) -> np.ndarray:
    height, width = labels.shape
    n = _lib.vg_trace_boundary(
        labels.ctypes.data_as(_I32P), height, width,
        comp, sy, sx, buf.ctypes.data_as(_F64P), len(buf),
    )
    if n < 0:
        raise RuntimeError('native contour tracing failed')
    return buf[:n].copy()


def _trace_buffer(shape: Tuple[int, int]) -> np.ndarray:
    # Spurs traverse twice, so a boundary can touch every pixel twice.
    return np.empty((2 * shape[0] * shape[1] + 16, 2), dtype=np.float64)


def external_contours(np_mask: np.ndarray) -> List[np.ndarray]:
    labels, num = _label8(np_mask)
    contours: List[np.ndarray] = []
    if num == 0:
        return contours
    firsts = _first_occurrences(labels, num)
    width = np_mask.shape[1]
    buf = _trace_buffer(np_mask.shape)
    for comp in range(1, num + 1):
        idx = int(firsts[comp - 1])
        contours.append(_trace(labels, comp, idx // width, idx % width, buf))
    return contours


def disconnected_components(np_mask: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
    labels, num = _label8(np_mask)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    if num == 0:
        return out
    firsts = _first_occurrences(labels, num)
    width = np_mask.shape[1]
    buf = _trace_buffer(np_mask.shape)
    for comp in range(1, num + 1):
        idx = int(firsts[comp - 1])
        contour = _trace(labels, comp, idx // width, idx % width, buf)
        out.append((contour, (labels == comp).astype(np.uint8)))
    return out
