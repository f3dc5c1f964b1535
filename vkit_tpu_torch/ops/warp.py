"""Backward-map bilinear remap with a constant border.

Port of the bilinear branch of vkit_tpu/ops/warp.py ``remap_f32``, batched
over a leading sample axis.  Each of the four taps that falls outside the
source reads the border value (cv2 BORDER_CONSTANT per-tap masking).
``torch.nn.functional.grid_sample`` pads only with zeros or the edge pixel,
so the gather is written out.

The numpy host half (``remap_np``, ``affine_maps_np``, ``warp_affine_np``,
``affine_np_points``, ``solve_perspective``, ``solve_perspective_batch``,
``rect_to_quad_mats``) is the reference's own code: WarpPlan and the
per-element geometric distortions call it.
"""
from typing import Tuple

import numpy as np
import torch


def remap_f32(images, map_y, map_x, border_value: float = 0.0):
    """Bilinear backward warp of (N, H, W, C) by (N, H', W') float maps ->
    (N, H', W', C) float32."""
    images = images.to(torch.float32)
    n, height, width, channels = images.shape
    flat = images.reshape(n, height * width, channels)

    y0f = torch.floor(map_y)
    x0f = torch.floor(map_x)
    wy = (map_y - y0f)[..., None]
    wx = (map_x - x0f)[..., None]
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    border = torch.full((), border_value, dtype=torch.float32,
                        device=images.device)

    def tap(ys, xs):
        valid = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
        idx = ys.clamp(0, height - 1) * width + xs.clamp(0, width - 1)
        idx = idx.reshape(n, -1, 1).expand(-1, -1, channels)
        vals = torch.gather(flat, 1, idx).reshape(*ys.shape, channels)
        return torch.where(valid[..., None], vals, border)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def to_image_dtype(x, dtype):
    """float32 result -> ``dtype``: integer images round and clip to
    [0, 255] (the reference's uint8 rule), float images cast."""
    if not dtype.is_floating_point:
        return torch.clamp(torch.round(x), 0, 255).to(dtype)
    return x.to(dtype)


# --------------------------------------------------------------------------
# Host (numpy) twins — for per-element distortion of dynamic-shaped rasters
# and the warp planners; the torch path above is the batched device form.
# --------------------------------------------------------------------------


_REMAP_NATIVE = None
_REMAP_NATIVE_TRIED = False


def _remap_native(src_f32, map_y, map_x, border):
    """C++ bilinear remap (vkit_tpu/native); None if unavailable."""
    global _REMAP_NATIVE, _REMAP_NATIVE_TRIED
    if not _REMAP_NATIVE_TRIED:
        _REMAP_NATIVE_TRIED = True
        try:
            from ..native import load_library
            _REMAP_NATIVE = load_library()
        except Exception:  # noqa: BLE001
            _REMAP_NATIVE = None
    if _REMAP_NATIVE is None:
        return None

    import ctypes
    f32p = ctypes.POINTER(ctypes.c_float)
    height, width, channels = src_f32.shape
    out_h, out_w = map_y.shape
    src_c = np.ascontiguousarray(src_f32)
    my = np.ascontiguousarray(map_y, dtype=np.float32)
    mx = np.ascontiguousarray(map_x, dtype=np.float32)
    border_c = np.ascontiguousarray(border, dtype=np.float32)
    out = np.empty((out_h, out_w, channels), dtype=np.float32)
    _REMAP_NATIVE.vg_remap_f32(
        src_c.ctypes.data_as(f32p), height, width, channels,
        my.ctypes.data_as(f32p), mx.ctypes.data_as(f32p), out_h, out_w,
        border_c.ctypes.data_as(f32p), out.ctypes.data_as(f32p),
    )
    return out


def remap_np(
    image: np.ndarray,
    map_y: np.ndarray,
    map_x: np.ndarray,
    interpolation: str = 'bilinear',
    border_value: float = 0.0,
) -> np.ndarray:
    """Numpy twin of :func:`remap` (identical tap/border semantics).

    Bilinear goes through the native C++ kernel when available (bit-equal
    float order; the numpy formulation allocates ~20 page-sized temporaries,
    which is pathological at production page sizes)."""
    had_c = image.ndim == 3
    image3 = image if had_c else image[..., None]
    src = image3.astype(np.float32)
    height, width = src.shape[:2]
    border = np.broadcast_to(
        np.asarray(border_value, dtype=np.float32), (src.shape[-1],)
    )

    if interpolation == 'bilinear':
        native_out = _remap_native(src, map_y, map_x, border)
        if native_out is not None:
            out = native_out if had_c else native_out[..., 0]
            if image.dtype == np.uint8:
                return np.clip(np.round(out), 0, 255).astype(np.uint8)
            return out.astype(image.dtype)

    flat = src.reshape(height * width, -1)

    def tap(ys, xs):
        valid = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
        ys_c = np.clip(ys, 0, height - 1)
        xs_c = np.clip(xs, 0, width - 1)
        vals = flat[(ys_c * width + xs_c).reshape(-1)].reshape(
            *ys.shape, flat.shape[-1]
        )
        return np.where(valid[..., None], vals, border)

    if interpolation == 'nearest':
        ys = np.round(map_y).astype(np.int64)
        xs = np.round(map_x).astype(np.int64)
        out = tap(ys, xs)
    elif interpolation == 'bilinear':
        y0f = np.floor(map_y)
        x0f = np.floor(map_x)
        wy = (map_y - y0f)[..., None].astype(np.float32)
        wx = (map_x - x0f)[..., None].astype(np.float32)
        y0 = y0f.astype(np.int64)
        x0 = x0f.astype(np.int64)
        out = (
            tap(y0, x0) * (1 - wy) * (1 - wx)
            + tap(y0, x0 + 1) * (1 - wy) * wx
            + tap(y0 + 1, x0) * wy * (1 - wx)
            + tap(y0 + 1, x0 + 1) * wy * wx
        )
    else:
        raise NotImplementedError(interpolation)

    if not had_c:
        out = out[..., 0]
    if image.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)


def affine_maps_np(trans_mat: np.ndarray, dst_shape: Tuple[int, int]):
    """Numpy twin of :func:`affine_maps` (rank-1 broadcast form — the
    (H, W, 3) homogeneous-grid matmul materialized 3x the temporaries)."""
    trans_mat = np.asarray(trans_mat, dtype=np.float64)
    if trans_mat.shape == (2, 3):
        full = np.vstack([trans_mat, [0.0, 0.0, 1.0]])
    else:
        assert trans_mat.shape == (3, 3)
        full = trans_mat
    inv = np.linalg.inv(full)

    dst_h, dst_w = dst_shape
    gx = np.arange(dst_w, dtype=np.float64)[None, :]
    gy = np.arange(dst_h, dtype=np.float64)[:, None]
    sx = inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]
    sy = inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]
    if np.abs(inv[2, :2]).max() > 1e-12:
        w = inv[2, 0] * gx + inv[2, 1] * gy + inv[2, 2]
        w = np.where(np.abs(w) < 1e-12, 1.0, w)
        sx = sx / w
        sy = sy / w
    return sy.astype(np.float32), sx.astype(np.float32)


def warp_affine_np(
    image: np.ndarray,
    trans_mat: np.ndarray,
    dst_shape: Tuple[int, int],
    interpolation: str = 'bilinear',
    border_value: float = 0.0,
) -> np.ndarray:
    map_y, map_x = affine_maps_np(trans_mat, dst_shape)
    return remap_np(image, map_y, map_x, interpolation, border_value)


warp_perspective_np = warp_affine_np


def affine_np_points(trans_mat: np.ndarray, np_points: np.ndarray) -> np.ndarray:
    """Forward-transform (P, 2) xy points by a 2x3 / 3x3 matrix (host-side).

    Capability parity: vkit/mechanism/distortion/geometric/affine.py:46-64.
    """
    np_points = np.asarray(np_points, dtype=np.float64)
    homo = np.hstack([np_points, np.ones((len(np_points), 1))])
    if trans_mat.shape == (2, 3):
        out = homo @ trans_mat.T
        return out
    assert trans_mat.shape == (3, 3)
    out = homo @ trans_mat.T
    denom = out[:, 2:3]
    denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    return out[:, :2] / denom


def solve_perspective(src_xy: np.ndarray, dst_xy: np.ndarray) -> np.ndarray:
    """4-point homography solve (host-side, least squares).

    Capability parity: cv2.getPerspectiveTransform at
    vkit/mechanism/distortion/geometric/grid_rendering/type.py:172,189.
    """
    src_xy = np.asarray(src_xy, dtype=np.float64)
    dst_xy = np.asarray(dst_xy, dtype=np.float64)
    assert src_xy.shape == (4, 2) and dst_xy.shape == (4, 2)
    rows = []
    rhs = []
    for (x, y), (u, v) in zip(src_xy, dst_xy):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rhs.append(u)
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs.append(v)
    coeffs, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs), rcond=None)
    return np.append(coeffs, 1.0).reshape(3, 3)


def solve_perspective_batch(src_quads: np.ndarray, dst_quads: np.ndarray) -> np.ndarray:
    """Batched 4-point homography solve: (N,4,2),(N,4,2) -> (N,3,3)."""
    n = src_quads.shape[0]
    a = np.zeros((n, 8, 8), dtype=np.float64)
    b = np.zeros((n, 8), dtype=np.float64)
    x = src_quads[:, :, 0]
    y = src_quads[:, :, 1]
    u = dst_quads[:, :, 0]
    v = dst_quads[:, :, 1]
    for k in range(4):
        r0 = 2 * k
        a[:, r0, 0] = x[:, k]
        a[:, r0, 1] = y[:, k]
        a[:, r0, 2] = 1
        a[:, r0, 6] = -u[:, k] * x[:, k]
        a[:, r0, 7] = -u[:, k] * y[:, k]
        b[:, r0] = u[:, k]
        r1 = r0 + 1
        a[:, r1, 3] = x[:, k]
        a[:, r1, 4] = y[:, k]
        a[:, r1, 5] = 1
        a[:, r1, 6] = -v[:, k] * x[:, k]
        a[:, r1, 7] = -v[:, k] * y[:, k]
        b[:, r1] = v[:, k]
    try:
        coeffs = np.linalg.solve(a, b[..., None])[..., 0]
    except np.linalg.LinAlgError:
        # Degenerate cells (collapsed quads): least-squares per cell, which
        # matches cv2.getPerspectiveTransform(DECOMP_SVD) behavior there.
        coeffs = np.empty((n, 8))
        for idx in range(n):
            coeffs[idx], *_ = np.linalg.lstsq(a[idx], b[idx], rcond=None)
    out = np.concatenate([coeffs, np.ones((n, 1))], axis=1)
    return out.reshape(n, 3, 3)

def rect_to_quad_mats(rects: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Closed-form homographies mapping axis-aligned rectangles onto
    quads: (N, 4) rects (x_left, y_top, x_right, y_bottom) and (N, 4, 2)
    quads (clockwise from up-left) -> (N, 3, 3).

    The 8x8 linear solve in solve_perspective_batch costs ~2us per cell;
    a warp lattice has ~6k cells per plan, and its SOURCE cells are
    axis-aligned by construction — the unit-square-to-quad projective map
    has a 30-flop closed form, fully vectorized here.
    """
    rects = np.asarray(rects, dtype=np.float64)
    quads = np.asarray(quads, dtype=np.float64)
    x0, y0 = quads[:, 0, 0], quads[:, 0, 1]
    x1, y1 = quads[:, 1, 0], quads[:, 1, 1]
    x2, y2 = quads[:, 2, 0], quads[:, 2, 1]
    x3, y3 = quads[:, 3, 0], quads[:, 3, 1]

    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1 = x1 - x2
    dy1 = y1 - y2
    dx2 = x3 - x2
    dy2 = y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = np.where(np.abs(den) < 1e-12, 1e-12, den)
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den

    n = len(quads)
    hu = np.empty((n, 3, 3), dtype=np.float64)
    hu[:, 0, 0] = x1 - x0 + g * x1
    hu[:, 0, 1] = x3 - x0 + h * x3
    hu[:, 0, 2] = x0
    hu[:, 1, 0] = y1 - y0 + g * y1
    hu[:, 1, 1] = y3 - y0 + h * y3
    hu[:, 1, 2] = y0
    hu[:, 2, 0] = g
    hu[:, 2, 1] = h
    hu[:, 2, 2] = 1.0

    # Pre-compose with rect -> unit square (scale + translate).
    w = np.maximum(rects[:, 2] - rects[:, 0], 1e-12)
    hgt = np.maximum(rects[:, 3] - rects[:, 1], 1e-12)
    s = np.zeros((n, 3, 3), dtype=np.float64)
    s[:, 0, 0] = 1.0 / w
    s[:, 0, 2] = -rects[:, 0] / w
    s[:, 1, 1] = 1.0 / hgt
    s[:, 1, 2] = -rects[:, 1] / hgt
    s[:, 2, 2] = 1.0
    out = np.einsum('nij,njk->nik', hu, s)
    # Normalize like the linear solver (H[2,2] = 1).
    return out / out[:, 2:3, 2:3]
