"""Streak-family photometric ops (3): line / rectangle / ellipse streaks.

Behavioral spec: vkit/mechanism/distortion/photometric/streak.py:24-337
(re-derived).  Streak footprints build as vectorized numpy stencils
(modular-arithmetic line fields, slice-filled frame bars, implicit-equation
ellipse rings — no cv.ellipse); the batched device path reuses the same
stencil builders directly.
"""
from typing import List, Optional, Tuple

import attr
import numpy as np

from ....element import Box, Image, Mask
from ..interface import DistortionConfig
from .base import photometric_op


def _dash_rows(length: int, dash_thickness: int, dash_gap: int) -> np.ndarray:
    """Bool vector: True where the dash gap blanks this row/column."""
    if dash_thickness <= 0 or dash_gap <= 0:
        return np.zeros(length, dtype=bool)
    period = dash_thickness + dash_gap
    return (np.arange(length) % period) < dash_gap


def line_streak_stencils(
    shape: Tuple[int, int],
    thickness: int,
    gap: int,
    dash_thickness: int = 0,
    dash_gap: int = 0,
    enable_vert: bool = True,
    enable_hori: bool = True,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(vertical, horizontal) uint8 stencils, or None where disabled."""
    height, width = shape
    period = thickness + gap
    vert = hori = None
    if enable_vert:
        cols = (np.arange(width) % period) < thickness
        vert = np.broadcast_to(cols, shape) & ~_dash_rows(
            height, dash_thickness, dash_gap
        )[:, None]
        vert = vert.astype(np.uint8)
    if enable_hori:
        rows = (np.arange(height) % period) < thickness
        hori = rows[:, None] & ~_dash_rows(width, dash_thickness, dash_gap)[None, :]
        hori = hori.astype(np.uint8)
    return vert, hori


def concentric_boxes(
    height: int,
    width: int,
    aspect_ratio: float,
    short_side_min: int,
    short_side_step: int,
) -> List[Box]:
    """Centered boxes growing by short_side_step until both sides overflow."""
    center_y, center_x = height // 2, width // 2
    out: List[Box] = []
    idx = 0
    while True:
        short_side = short_side_min + idx * short_side_step
        if aspect_ratio >= 1:
            box_h = short_side
            box_w = round(box_h * aspect_ratio)
        elif 0 < aspect_ratio < 1:
            box_w = short_side
            box_h = round(box_w / aspect_ratio)
        else:
            raise NotImplementedError(f'aspect_ratio={aspect_ratio}')
        up = center_y - box_h // 2
        left = center_x - box_w // 2
        box = Box(up, up + box_h - 1, left, left + box_w - 1)
        if (0 <= box.up and box.down < height) or (0 <= box.left and box.right < width):
            out.append(box)
            idx += 1
        else:
            return out


def rectangle_streak_stencils(
    shape: Tuple[int, int],
    thickness: int,
    aspect_ratio: float,
    short_side_min: int,
    short_side_step: int,
    dash_thickness: int = 0,
    dash_gap: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(vertical-bar, horizontal-bar) stencils of concentric frames."""
    height, width = shape
    vert = np.zeros(shape, dtype=np.uint8)
    hori = np.zeros(shape, dtype=np.uint8)

    for box in concentric_boxes(height, width, aspect_ratio,
                                short_side_min, short_side_step):
        # Inner edges of the four frame bars.
        in_up = box.down - thickness + 1
        in_down = box.up + thickness - 1
        in_left = box.right - thickness + 1
        in_right = box.left + thickness - 1

        y0, y1 = max(0, box.up), min(height - 1, box.down)
        if y0 <= y1:
            if 0 <= in_right < width:
                vert[y0:y1 + 1, max(0, box.left):in_right + 1] = 1
            if 0 <= in_left < width:
                vert[y0:y1 + 1, in_left:min(width - 1, box.right) + 1] = 1

        x0, x1 = max(0, in_right + 1), min(width - 1, in_left - 1)
        if x0 <= x1:
            if 0 <= in_down < height:
                hori[max(0, box.up):in_down + 1, x0:x1 + 1] = 1
            if 0 <= in_up < height:
                hori[in_up:min(height - 1, box.down) + 1, x0:x1 + 1] = 1

    vert[_dash_rows(height, dash_thickness, dash_gap)] = 0
    hori[:, _dash_rows(width, dash_thickness, dash_gap)] = 0
    return vert, hori


def ellipse_ring_stencil(
    shape: Tuple[int, int],
    center_xy: Tuple[int, int],
    axes_list: List[Tuple[int, int]],
    thickness: int,
) -> np.ndarray:
    """Union of stroked ellipse outlines, cv.ellipse-rasterized.

    Rings draw through the cv2-compatible integer primitives
    (ops/cvraster.py): the ellipse2Poly vertex chain, per-segment
    fixed-point quads with Bresenham outlines, and filled midpoint
    circles at the joins.  Thickness 1 is BIT-EXACT vs cv.ellipse
    (oracle-fitted Bresenham); thickness >= 2 differs on boundary pixels
    only — cv's convex-poly scan bounds spans by a subpixel edge walker
    whose exact integer drift resisted black-box reconstruction, so
    t == 2 keeps the implicit-band stroke (measured closer there: 826 vs
    1000 differing px on the parity ring set; t >= 3 the quad
    rasterization is closer, 725 vs 987).
    """
    from ....ops.cvraster import draw_ellipse

    height, width = shape
    if thickness == 2:
        cx, cy = center_xy
        ys = np.arange(height, dtype=np.float64)[:, None] - cy
        xs = np.arange(width, dtype=np.float64)[None, :] - cx
        half = thickness - 0.5
        stencil = np.zeros(shape, dtype=bool)
        for a, b in axes_list:
            if a <= 0 or b <= 0:
                continue
            value = (xs / a) ** 2 + (ys / b) ** 2 - 1.0
            grad = 2.0 * np.hypot(xs / (a * a), ys / (b * b))
            stencil |= np.abs(value) / np.maximum(grad, 1e-9) <= half
        return stencil.astype(np.uint8)

    stencil = np.zeros(shape, dtype=np.uint8)
    for a, b in axes_list:
        if a < 0 or b < 0:
            continue
        draw_ellipse(stencil, center_xy, (a, b), thickness)
    return stencil


def _blend_stencils(image: Image, stencils, color, alpha: float) -> Image:
    out = image.copy()
    for stencil in stencils:
        if stencil is None or not stencil.any():
            continue
        Mask(mat=stencil).fill_image(out, color, alpha=alpha)
    return out


@attr.define
class LineStreakConfig(DistortionConfig):
    thickness: int = 1
    gap: int = 4
    dash_thickness: int = 0
    dash_gap: int = 0
    color: Tuple[int, int, int] = (0, 0, 0)
    alpha: float = 1.0
    enable_vert: bool = True
    enable_hori: bool = True


@photometric_op(LineStreakConfig)
def line_streak(config: LineStreakConfig, image: Image, rng) -> Image:
    vert, hori = line_streak_stencils(
        image.shape, config.thickness, config.gap,
        config.dash_thickness, config.dash_gap,
        config.enable_vert, config.enable_hori,
    )
    return _blend_stencils(image, (vert, hori), config.color, config.alpha)


@attr.define
class RectangleStreakConfig(DistortionConfig):
    thickness: int = 1
    aspect_ratio: Optional[float] = None
    dash_thickness: int = 0
    dash_gap: int = 0
    short_side_min: int = 10
    short_side_step: int = 10
    color: Tuple[int, int, int] = (0, 0, 0)
    alpha: float = 1.0


@photometric_op(RectangleStreakConfig)
def rectangle_streak(config: RectangleStreakConfig, image: Image, rng) -> Image:
    aspect = config.aspect_ratio
    if aspect is None:
        aspect = image.width / image.height
    vert, hori = rectangle_streak_stencils(
        image.shape, config.thickness, aspect,
        config.short_side_min, config.short_side_step,
        config.dash_thickness, config.dash_gap,
    )
    return _blend_stencils(image, (vert, hori), config.color, config.alpha)


@attr.define
class EllipseStreakConfig(DistortionConfig):
    thickness: int = 1
    aspect_ratio: Optional[float] = None
    short_side_min: int = 10
    short_side_step: int = 10
    color: Tuple[int, int, int] = (0, 0, 0)
    alpha: float = 1.0


@photometric_op(EllipseStreakConfig)
def ellipse_streak(config: EllipseStreakConfig, image: Image, rng) -> Image:
    aspect = config.aspect_ratio
    if aspect is None:
        aspect = image.width / image.height
    boxes = concentric_boxes(
        image.height, image.width, aspect,
        config.short_side_min, config.short_side_step,
    )
    stencil = ellipse_ring_stencil(
        image.shape,
        (image.width // 2, image.height // 2),
        [(box.width // 2, box.height // 2) for box in boxes],
        config.thickness,
    )
    return _blend_stencils(image, (stencil,), config.color, config.alpha)


def draw_ellipse_ring(
    np_mask: np.ndarray,
    center_xy: Tuple[int, int],
    axes: Tuple[int, int],
    thickness: int,
) -> None:
    """In-place single stroked ellipse (used by the seal-impression engine)."""
    stencil = ellipse_ring_stencil(np_mask.shape, center_xy, [axes], thickness)
    np_mask[stencil > 0] = 1
