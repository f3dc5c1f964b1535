"""Resize tap-weight construction + pure-numpy resize.

Capability parity: the cv2.resize interpolation family used throughout the
reference (vkit/element/image.py:847, mask.py:471, score_map.py:628,
vkit/utility/opt.py:125-148): NEAREST, NEAREST_EXACT, LINEAR(_EXACT), CUBIC,
AREA, LANCZOS4.

Design: every separable resize is expressed as two dense weight matrices,
``out = W_rows @ img @ W_cols.T``.  On TPU the same matrices drive the MXU
(see vkit_tpu/ops/resize.py); on host this module applies them with numpy.
This file must not import jax (the element layer depends on it).
"""
from enum import Enum, unique
from typing import Tuple

import numpy as np


@unique
class Interpolation(Enum):
    NEAREST = 'nearest'
    NEAREST_EXACT = 'nearest_exact'
    LINEAR = 'linear'
    LINEAR_EXACT = 'linear_exact'
    CUBIC = 'cubic'
    AREA = 'area'
    LANCZOS4 = 'lanczos4'


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic with A=-0.75 (OpenCV's INTER_CUBIC coefficient)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


def _lanczos_kernel(x: np.ndarray, a: int = 4) -> np.ndarray:
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, out, 0.0)


def build_resize_weights(
    n_src: int,
    n_dst: int,
    interpolation: Interpolation,
) -> np.ndarray:
    """(n_dst, n_src) float32 row-stochastic weight matrix."""
    assert n_src > 0 and n_dst > 0
    scale = n_src / n_dst
    dst = np.arange(n_dst, dtype=np.float64)

    if interpolation is Interpolation.NEAREST:
        src_idx = np.floor(dst * scale).astype(np.int64)
        src_idx = np.clip(src_idx, 0, n_src - 1)
        weights = np.zeros((n_dst, n_src), dtype=np.float32)
        weights[dst.astype(np.int64), src_idx] = 1.0
        return weights

    if interpolation is Interpolation.NEAREST_EXACT:
        src_idx = np.floor((dst + 0.5) * scale).astype(np.int64)
        src_idx = np.clip(src_idx, 0, n_src - 1)
        weights = np.zeros((n_dst, n_src), dtype=np.float32)
        weights[dst.astype(np.int64), src_idx] = 1.0
        return weights

    if interpolation is Interpolation.AREA:
        # Exact fractional pixel coverage of [i*scale, (i+1)*scale) — valid
        # in BOTH directions: for upscale the cell straddles at most two
        # source pixels (integer upscale degenerates to nearest, matching
        # cv2.INTER_AREA).
        weights = np.zeros((n_dst, n_src), dtype=np.float64)
        starts = dst * scale
        ends = starts + scale
        for i in range(n_dst):
            lo = starts[i]
            hi = ends[i]
            j0 = int(np.floor(lo))
            j1 = min(int(np.ceil(hi)), n_src)
            for j in range(j0, j1):
                cover = min(hi, j + 1) - max(lo, j)
                if cover > 0:
                    weights[i, j] = cover / scale
        return weights.astype(np.float32)

    # Convolutional kernels share the half-pixel-center mapping.
    centers = (dst + 0.5) * scale - 0.5

    if interpolation in (Interpolation.LINEAR, Interpolation.LINEAR_EXACT):
        radius, kernel = 1, None
    elif interpolation is Interpolation.CUBIC:
        radius, kernel = 2, _cubic_kernel
    elif interpolation is Interpolation.LANCZOS4:
        radius, kernel = 4, _lanczos_kernel
    else:
        raise NotImplementedError(interpolation)

    base = np.floor(centers).astype(np.int64)
    weights = np.zeros((n_dst, n_src), dtype=np.float64)
    taps = np.arange(1 - radius, radius + 1)
    for tap in taps:
        idx = base + tap
        dist = centers - idx
        if kernel is None:
            w = np.maximum(0.0, 1.0 - np.abs(dist))
        else:
            w = kernel(dist)
        clipped = np.clip(idx, 0, n_src - 1)
        np.add.at(weights, (np.arange(n_dst), clipped), w)
    # Normalize rows (cv2 normalizes tap sums).
    weights /= weights.sum(axis=1, keepdims=True)
    return weights.astype(np.float32)


import functools


@functools.lru_cache(maxsize=4096)
def build_resize_taps(
    n_src: int,
    n_dst: int,
    interpolation: Interpolation,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse form of build_resize_weights: (idx, w), each (n_dst, T).

    ``out[i] = sum_t src[idx[i, t]] * w[i, t]``.  The dense matrix drives
    the MXU on device; this drives the O(N^2 * T) host path (a dense
    matmul at page sizes is O(N^3) — seconds at 2522^2).  Results are
    cached (read-only) — the same box/char sizes recur constantly.
    """
    dense = build_resize_weights(n_src, n_dst, interpolation)
    nz_counts = (dense != 0).sum(axis=1)
    t = max(int(nz_counts.max()), 1)
    idx = np.zeros((n_dst, t), dtype=np.int64)
    w = np.zeros((n_dst, t), dtype=np.float64)
    for i in range(n_dst):
        nz = np.flatnonzero(dense[i])
        idx[i, :len(nz)] = nz
        w[i, :len(nz)] = dense[i, nz]
    idx.setflags(write=False)
    w.setflags(write=False)
    return idx, w


_NATIVE_LIB = None
_NATIVE_TRIED = False


def _resize_native(src, idx_r, w_r, idx_c, w_c, h_out, w_out):
    """C++ tap-resize (vkit_tpu/native); None if the library is absent."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from ..native import load_library
            _NATIVE_LIB = load_library()
        except Exception:  # noqa: BLE001
            _NATIVE_LIB = None
    if _NATIVE_LIB is None:
        return None

    import ctypes
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)

    had_c = src.ndim == 3
    x = src if had_c else src[:, :, None]
    x = np.ascontiguousarray(x, dtype=np.float32)
    height, width, channels = x.shape
    tmp = np.empty((h_out, width, channels), dtype=np.float32)
    out = np.empty((h_out, w_out, channels), dtype=np.float32)
    idx_r32 = np.ascontiguousarray(idx_r, dtype=np.int32)
    idx_c32 = np.ascontiguousarray(idx_c, dtype=np.int32)
    w_r32 = np.ascontiguousarray(w_r, dtype=np.float32)
    w_c32 = np.ascontiguousarray(w_c, dtype=np.float32)
    _NATIVE_LIB.vg_resize_f32(
        x.ctypes.data_as(f32p), height, width, channels,
        idx_r32.ctypes.data_as(i32p), w_r32.ctypes.data_as(f32p),
        idx_r32.shape[1], h_out,
        idx_c32.ctypes.data_as(i32p), w_c32.ctypes.data_as(f32p),
        idx_c32.shape[1], w_out,
        tmp.ctypes.data_as(f32p), out.ctypes.data_as(f32p),
    )
    return out if had_c else out[:, :, 0]


def resize_np(
    mat: np.ndarray,
    resized_shape: Tuple[int, int],
    interpolation: Interpolation = Interpolation.LINEAR,
) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) numpy array; preserves dtype.

    Same tap weights as the device matmul path, applied via the native C++
    kernel when available (numpy fallback; float32 accumulation, like
    cv2)."""
    resized_height, resized_width = resized_shape
    height, width = mat.shape[:2]
    if (height, width) == (resized_height, resized_width):
        return mat.copy()

    idx_r, w_r = build_resize_taps(height, resized_height, interpolation)
    idx_c, w_c = build_resize_taps(width, resized_width, interpolation)
    w_r = w_r.astype(np.float32)
    w_c = w_c.astype(np.float32)

    src = mat.astype(np.float32)

    native_out = _resize_native(
        src, idx_r, w_r, idx_c, w_c, resized_height, resized_width
    )
    if native_out is not None:
        if np.issubdtype(mat.dtype, np.integer):
            info = np.iinfo(mat.dtype)
            native_out = np.clip(np.round(native_out), info.min, info.max)
        return native_out.astype(mat.dtype)

    extra = (1,) * (src.ndim - 1)

    def axis0_pass(x, idx, w):
        out = np.zeros((idx.shape[0],) + x.shape[1:], dtype=np.float32)
        for t in range(idx.shape[1]):
            out += x[idx[:, t]] * w[:, t].reshape(-1, *extra)
        return out

    def transpose01(x):
        # Contiguous leading-axis layout: gathers become big row memcpys.
        return np.ascontiguousarray(np.moveaxis(x, 1, 0))

    # Order the passes to keep intermediates small (rows-first cost scales
    # with H_out * W_in; cols-first with H_in * W_out).
    rows_first = (
        resized_height * width + resized_height * resized_width
        <= height * resized_width + resized_height * resized_width
    )
    if rows_first:
        out1 = axis0_pass(src, idx_r, w_r)                 # (H', W, C)
        out_t = axis0_pass(transpose01(out1), idx_c, w_c)  # (W', H', C)
        transposed = True
    else:
        out1 = axis0_pass(transpose01(src), idx_c, w_c)    # (W', H, C)
        out_t = axis0_pass(transpose01(out1), idx_r, w_r)  # (H', W', C)
        transposed = False

    # Convert dtype while contiguous, then lay out the result.
    if np.issubdtype(mat.dtype, np.integer):
        info = np.iinfo(mat.dtype)
        out_t = np.clip(np.round(out_t), info.min, info.max)
    out_t = out_t.astype(mat.dtype)
    if transposed:
        return np.ascontiguousarray(np.moveaxis(out_t, 1, 0))
    return out_t
