"""Analytic geometric distortions: shear, rotate, skew.

Each op is a small planner returning a matrix WarpPlan (forward 2x3 affine
or 3x3 homography + grown canvas).  Behavioral spec:
vkit/mechanism/distortion/geometric/affine.py:92-533 (re-derived; canvas
growth and origin shifts match the reference's dsize math exactly).
"""
import math
from typing import Tuple

import attr
import numpy as np

from ....ops import warp as warp_ops
from ..interface import DistortionConfig, GeometricDistortion
from ..warp_plan import WarpPlan, matrix_plan, nop_plan


@attr.define
class ShearHoriConfig(DistortionConfig):
    # (-90, 90); positive leans the vertical axis rightward.
    angle: int


def _shear_hori_plan(config: ShearHoriConfig, shape: Tuple[int, int], rng) -> WarpPlan:
    if config.angle == 0:
        return nop_plan(shape)
    height, width = shape
    tan_phi = math.tan(math.radians(config.angle))
    span = abs(height * tan_phi)
    # Negative shear leans left: content stays anchored at x=0; positive
    # shear pre-shifts by the span so x stays non-negative.
    offset = span if config.angle > 0 else 0.0
    matrix = np.asarray([(1, -tan_phi, offset), (0, 1, 0)], dtype=np.float32)
    return matrix_plan(matrix, shape, (height, math.ceil(width + span)))


@attr.define
class ShearVertConfig(DistortionConfig):
    # (-90, 90); positive leans the horizontal axis downward.
    angle: int


def _shear_vert_plan(config: ShearVertConfig, shape: Tuple[int, int], rng) -> WarpPlan:
    if config.angle == 0:
        return nop_plan(shape)
    height, width = shape
    tan_phi = math.tan(math.radians(abs(config.angle)))
    span = width * tan_phi
    if config.angle > 0:
        matrix = np.asarray([(1, 0, 0), (tan_phi, 1, 0)], dtype=np.float32)
    else:
        matrix = np.asarray([(1, 0, 0), (-tan_phi, 1, span)], dtype=np.float32)
    return matrix_plan(matrix, shape, (math.ceil(height + span), width))


@attr.define
class RotateConfig(DistortionConfig):
    # [0, 360], clockwise.
    angle: int


def _rotate_plan(config: RotateConfig, shape: Tuple[int, int], rng) -> WarpPlan:
    angle = config.angle % 360
    if angle == 0:
        return nop_plan(shape)
    height, width = shape
    rad = math.radians(angle)

    # Canvas growth + origin shift per quadrant so the rotated content
    # stays in the positive quadrant.
    if rad <= math.pi / 2:
        shift_x = height * math.sin(rad)
        shift_y = 0.0
        dst_w = height * math.sin(rad) + width * math.cos(rad)
        dst_h = height * math.cos(rad) + width * math.sin(rad)
    elif rad <= math.pi:
        phi = rad - math.pi / 2
        shift_x = width * math.sin(phi) + height * math.cos(phi)
        shift_y = height * math.sin(phi)
        dst_w = shift_x
        dst_h = shift_y + width * math.cos(phi)
    elif rad < math.pi * 3 / 2:
        phi = rad - math.pi
        shift_x = width * math.cos(phi)
        shift_y = width * math.sin(phi) + height * math.cos(phi)
        dst_w = shift_x + height * math.sin(phi)
        dst_h = shift_y
    else:
        phi = rad - math.pi * 3 / 2
        shift_x = 0.0
        shift_y = width * math.cos(phi)
        dst_w = width * math.sin(phi) + height * math.cos(phi)
        dst_h = shift_y + height * math.sin(phi)

    matrix = np.asarray(
        [
            (math.cos(rad), -math.sin(rad), math.ceil(shift_x)),
            (math.sin(rad), math.cos(rad), math.ceil(shift_y)),
        ],
        dtype=np.float32,
    )
    return matrix_plan(matrix, shape, (math.ceil(dst_h), math.ceil(dst_w)))


def _corner_quad(height: int, width: int) -> np.ndarray:
    return np.asarray(
        [(0, 0), (width - 1, 0), (width - 1, height - 1), (0, height - 1)],
        dtype=np.float64,
    )


def _quad_plan(shape: Tuple[int, int], dst_quad) -> WarpPlan:
    height, width = shape
    matrix = warp_ops.solve_perspective(
        _corner_quad(height, width),
        np.asarray(dst_quad, dtype=np.float64),
    ).astype(np.float32)
    return matrix_plan(matrix, shape, shape)


@attr.define
class SkewHoriConfig(DistortionConfig):
    # (-1, 0] squeezes the left edge, [0, 1) the right edge.
    ratio: float


def _skew_hori_plan(config: SkewHoriConfig, shape: Tuple[int, int], rng) -> WarpPlan:
    if config.ratio == 0:
        return nop_plan(shape)
    height, width = shape
    squeeze = round(height * abs(config.ratio))
    top = squeeze // 2
    bottom = squeeze - top
    if config.ratio < 0:
        dst = [(0, top), (width - 1, 0),
               (width - 1, height - 1), (0, height - bottom - 1)]
    else:
        dst = [(0, 0), (width - 1, top),
               (width - 1, height - bottom - 1), (0, height - 1)]
    return _quad_plan(shape, dst)


@attr.define
class SkewVertConfig(DistortionConfig):
    # (-1, 0] squeezes the top edge, [0, 1) the bottom edge.
    ratio: float


def _skew_vert_plan(config: SkewVertConfig, shape: Tuple[int, int], rng) -> WarpPlan:
    if config.ratio == 0:
        return nop_plan(shape)
    height, width = shape
    squeeze = round(width * abs(config.ratio))
    left = squeeze // 2
    right = squeeze - left
    if config.ratio < 0:
        dst = [(left, 0), (width - right - 1, 0),
               (width - 1, height - 1), (0, height - 1)]
    else:
        dst = [(0, 0), (width - 1, 0),
               (width - right - 1, height - 1), (right, height - 1)]
    return _quad_plan(shape, dst)


shear_hori = GeometricDistortion(ShearHoriConfig, _shear_hori_plan)
shear_vert = GeometricDistortion(ShearVertConfig, _shear_vert_plan)
rotate = GeometricDistortion(RotateConfig, _rotate_plan)
skew_hori = GeometricDistortion(SkewHoriConfig, _skew_hori_plan)
skew_vert = GeometricDistortion(SkewVertConfig, _skew_vert_plan)
