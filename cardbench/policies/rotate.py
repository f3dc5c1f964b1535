"""rotate: the page turned by a whole number of degrees onto the canvas
that holds it.

``sample`` is a frozen copy of ``rotate_policy_factory``'s sampler with
the defaults of ``RotateConfigGeneratorConfig``
(``vkit_tpu_torch/mechanism/distortion_policy/geometric/affine.py`` at
commit 413b729).  ``geometry`` works the warp out from the angle alone,
as vkit defines it: the page's corners turned by the angle (clockwise on
the screen, y pointing down), the turned page moved so that the corner of
its bounding box lands on the next whole pixel, and a canvas of the box's
extent rounded up."""
import math

import numpy as np

from cardbench.policies.common import Geometry, sample_int

ANGLE_MIN = 1
ANGLE_MAX = 180
PROB_NEGATIVE = 0.5
# Decimals a corner's coordinate keeps before it is rounded up.
ROUNDING = 9


def sample(level: int, shape, rng) -> dict:
    """One sample's config, drawn from ``rng``."""
    return dict(angle=sample_int(level, ANGLE_MIN, ANGLE_MAX, PROB_NEGATIVE,
                                 rng))


def geometry(config: dict, shape) -> Geometry:
    height, width = shape
    rad = math.radians(config['angle'] % 360)
    turn = np.asarray([[math.cos(rad), -math.sin(rad)],
                       [math.sin(rad), math.cos(rad)]])
    corners = np.asarray([[0, 0], [width, 0], [width, height], [0, height]],
                         np.float64) @ turn.T
    # A corner within rounding of a whole pixel (at quarter turns) is on it.
    low = np.round(corners.min(axis=0), ROUNDING)
    high = np.round(corners.max(axis=0), ROUNDING)
    matrix = np.eye(3)
    matrix[:2, :2] = turn
    matrix[:2, 2] = np.ceil(-low)
    extent = np.ceil(high - low).astype(np.int64)
    return Geometry(dst_shape=(int(extent[1]), int(extent[0])),
                    matrix=matrix)
