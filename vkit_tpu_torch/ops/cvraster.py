"""cv2-compatible integer rasterization primitives (host numpy).

OpenCV's drawing stack rasterizes thick curves as polyline segments:
each segment is a filled fixed-point quad (FillConvexPoly) whose outline
is traced by the 8-connected fixed-point Bresenham (Line2), with filled
midpoint circles at the joins (ThickLine).  The streak/seal ellipse
distortions need BIT-EXACT membership with cv.ellipse (the <1 LSB parity
bar — boundary pixels across many concentric rings add up), so this
module re-derives those primitives at the same fixed-point precision
(XY_SHIFT = 16) instead of approximating with implicit bands.

Capability parity: cv.ellipse at vkit/mechanism/distortion/photometric/
streak.py:317 and the seal-impression ring.  Validated pixel-exact
against cv2.line/circle/fillConvexPoly/ellipse oracles in
tests/ops/test_cvraster.py.
"""
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _clip_line(w_scaled: int, h_scaled: int, x1: int, y1: int,
               x2: int, y2: int):
    """cv::clipLine on fixed-point coords; returns None when fully out."""
    right = w_scaled - 1
    bottom = h_scaled - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)

    c1 = code(x1, y1)
    c2 = code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _cdiv((a - y1) * (x2 - x1), (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _cdiv((a - y2) * (x2 - x1), (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _cdiv((a - x1) * (y2 - y1), (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _cdiv((a - x2) * (y2 - y1), (x2 - x1))
                x2 = a
                c2 = 0
    if (c1 | c2) != 0:
        return None
    return x1, y1, x2, y2


def line2(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]):
    """cv Line2/Line pixel set for FIXED-POINT endpoints, LINE_8.

    Empirically bit-exact vs the cv2 oracle (600/600 random lines): the
    endpoints round to integer pixels ((p + HALF) >> SHIFT), the pair
    normalizes left-to-right, and the 8-connected Bresenham walks with a
    -1 tie offset on the midpoint division (both orientations)."""
    h, w = mask.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                         int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]))
    if clipped is None:
        return
    fx1, fy1, fx2, fy2 = clipped
    _bresenham8(
        mask,
        (fx1 + _HALF) >> XY_SHIFT, (fy1 + _HALF) >> XY_SHIFT,
        (fx2 + _HALF) >> XY_SHIFT, (fy2 + _HALF) >> XY_SHIFT,
    )


def _bresenham8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int):
    """8-connected Bresenham between INTEGER pixels, left-to-right
    normalized, -1 tie offset (the cv pixel pattern)."""
    h, w = mask.shape
    if x1 > x2:
        x1, x2, y1, y2 = x2, x1, y2, y1
    dx = x2 - x1
    dy = abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    if dx >= dy:
        ks = np.arange(dx + 1, dtype=np.int64)
        xs = x1 + ks
        ys = y1 + sy * ((2 * ks * dy + dx - 1) // (2 * dx)) if dx \
            else np.full(1, y1, dtype=np.int64)
    else:
        ks = np.arange(dy + 1, dtype=np.int64)
        ys = y1 + sy * ks
        xs = x1 + (2 * ks * dx + dy - 1) // (2 * dy)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[ok], xs[ok]] = 1


def line_int(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]):
    """cv Line() as reached by thickness-1 LINE_8 drawing with
    shift=XY_SHIFT: endpoints round to integer pixels FIRST, then the
    INTEGER-domain clip runs, then the Bresenham walk."""
    h, w = mask.shape
    x1 = (int(p1[0]) + _HALF) >> XY_SHIFT
    y1 = (int(p1[1]) + _HALF) >> XY_SHIFT
    x2 = (int(p2[0]) + _HALF) >> XY_SHIFT
    y2 = (int(p2[1]) + _HALF) >> XY_SHIFT
    clipped = _clip_line(w, h, x1, y1, x2, y2)
    if clipped is None:
        return
    _bresenham8(mask, *clipped)


def _hline(mask: np.ndarray, y: int, x1: int, x2: int):
    h, w = mask.shape
    if y < 0 or y >= h or x2 < 0 or x1 >= w:
        return
    mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1


def circle_fill(mask: np.ndarray, center: Tuple[int, int], radius: int):
    """cv Circle(..., fill=1): filled midpoint circle, INTEGER center."""
    cx, cy = center
    err = 0
    dx = radius
    dy = 0
    plus = 1
    minus = (radius << 1) - 1
    while dx >= dy:
        _hline(mask, cy - dy, cx - dx, cx + dx)
        _hline(mask, cy + dy, cx - dx, cx + dx)
        _hline(mask, cy - dx, cx - dy, cx + dy)
        _hline(mask, cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def fill_convex_poly(mask: np.ndarray, pts: Sequence[Tuple[int, int]]):
    """cv FillConvexPoly with shift=XY_SHIFT, LINE_8: Line2 outline +
    fixed-point scanline fill."""
    h, w = mask.shape
    npts = len(pts)
    p0 = pts[-1]
    ymin = ymax = pts[0][1]
    xmin = xmax = pts[0][0]
    imin = 0
    for i, p in enumerate(pts):
        if p[1] < ymin:
            ymin = p[1]
            imin = i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        line2(mask, p0, p)
        p0 = p

    xmin = (xmin + _HALF) >> XY_SHIFT
    xmax = (xmax + _HALF) >> XY_SHIFT
    ymin = (ymin + _HALF) >> XY_SHIFT
    ymax = (ymax + _HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)

    edge_idx = [imin, imin]
    edge_ye = [ymin, ymin]
    edge_di = [1, npts - 1]
    edge_x = [-XY_ONE, -XY_ONE]
    edge_dx = [0, 0]
    edges = npts
    y = ymin
    while y <= ymax:
        for i in range(2):
            if y >= edge_ye[i]:
                idx0 = edge_idx[i]
                di = edge_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + _HALF) >> XY_SHIFT
                    if ty > y:
                        xs = pts[idx0][0]
                        xe = pts[idx][0]
                        edge_ye[i] = ty
                        edge_dx[i] = _cdiv(
                            (xe - xs) * 2 + (ty - y), 2 * (ty - y)
                        )
                        edge_x[i] = xs
                        edge_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                    if idx < 0:
                        idx += npts
                else:
                    edges = -1
        if edges < 0:
            break
        if y >= 0:
            left, right = (0, 1) if edge_x[0] <= edge_x[1] else (1, 0)
            xx1 = (edge_x[left] + _HALF) >> XY_SHIFT
            xx2 = (edge_x[right] + _HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(mask, y, max(xx1, 0), min(xx2, w - 1))
        edge_x[0] += edge_dx[0]
        edge_x[1] += edge_dx[1]
        y += 1


def thick_line(mask: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
               thickness: int, flags: int):
    """cv ThickLine for LINE_8, fixed-point endpoints, thickness >= 1.

    ``flags``: bit 0 -> cap at p0, bit 1 -> cap at p1 (round joins)."""
    if thickness <= 1:
        line_int(mask, p0, p1)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t_scaled = thickness << (XY_SHIFT - 1)
    if r > 2.2e-16:
        r = (t_scaled + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx = int(np.rint(dy * r))
        dpy = int(np.rint(dx * r))
        quad = [
            (p0[0] + dpx, p0[1] + dpy),
            (p0[0] - dpx, p0[1] - dpy),
            (p1[0] - dpx, p1[1] - dpy),
            (p1[0] + dpx, p1[1] + dpy),
        ]
        fill_convex_poly(mask, quad)
    for i in range(2):
        if flags & (i + 1):
            cx = ((p0[0] + _HALF) & ~(XY_ONE - 1)) >> XY_SHIFT
            cy = ((p0[1] + _HALF) & ~(XY_ONE - 1)) >> XY_SHIFT
            circle_fill(mask, (cx, cy),
                        (t_scaled + _HALF) >> XY_SHIFT)
        p0 = p1


def polyline(mask: np.ndarray, pts: Sequence[Tuple[int, int]],
             thickness: int):
    """cv PolyLine (is_closed=False) over fixed-point points."""
    if not pts:
        return
    flags = 3
    p0 = pts[0]
    for p1 in pts[1:]:
        thick_line(mask, p0, p1, thickness, flags)
        p0 = p1
        flags = 2


_SIN_TABLE = np.sin(np.deg2rad(np.arange(0, 491,
                                         dtype=np.float64))).astype(
                                             np.float32)


def ellipse_poly_points(center_xy: Tuple[int, int], axes: Tuple[int, int]
                        ) -> List[Tuple[int, int]]:
    """cv EllipseEx point generation for angle=0, arc 0..360: ellipse2Poly
    in the fixed-point domain + per-point rounding/dedup."""
    cx = center_xy[0] << XY_SHIFT
    cy = center_xy[1] << XY_SHIFT
    ax = axes[0] << XY_SHIFT
    ay = axes[1] << XY_SHIFT
    size = (max(ax, ay) + _HALF) >> XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5

    pts: List[Tuple[int, int]] = []
    prev = None
    for i in range(0, 360 + delta, delta):
        ang = min(i, 360)
        x = float(ax) * float(_SIN_TABLE[450 - ang])
        y = float(ay) * float(_SIN_TABLE[ang])
        px = cx + x
        py = cy + y
        # EllipseEx rounds to the nearest integer pixel, then adds the
        # rounded fixed-point remainder.
        ix = int(np.rint(px / XY_ONE)) << XY_SHIFT
        iy = int(np.rint(py / XY_ONE)) << XY_SHIFT
        ix += int(np.rint(px - ix))
        iy += int(np.rint(py - iy))
        if (ix, iy) != prev:
            pts.append((ix, iy))
            prev = (ix, iy)
    return pts


def draw_ellipse(mask: np.ndarray, center_xy: Tuple[int, int],
                 axes: Tuple[int, int], thickness: int):
    """cv.ellipse(angle=0, 0..360, LINE_8, positive thickness) clone."""
    pts = ellipse_poly_points(center_xy, axes)
    polyline(mask, pts, thickness)
