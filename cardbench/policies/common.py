"""What the policies share: vkit's level window (frozen copies of
``sample_int`` and ``sample_float`` in linear mode from
``vkit_tpu_torch/mechanism/distortion_policy/opt.py`` at commit 413b729)
and the plain description of a warp that the reference reads."""
from typing import NamedTuple, Optional, Tuple

import numpy as np

LEVEL_MAX = 10


class Geometry(NamedTuple):
    """A warp as the reference reads it: a forward 3x3 ``matrix``, or a
    lattice of source nodes (R, C, 2) xy spaced ``grid_size`` apart and
    where each lands on the canvas; ``dst_shape`` (h, w) of the canvas."""
    dst_shape: Tuple[int, int]
    matrix: Optional[np.ndarray] = None
    src_lattice: Optional[np.ndarray] = None
    dst_lattice: Optional[np.ndarray] = None
    grid_size: Optional[int] = None


def _level_window(level: int):
    return (level - 1) / LEVEL_MAX, level / LEVEL_MAX


def sample_int(level, value_min, value_max, prob_negative, rng) -> int:
    lo, hi = _level_window(level)
    span = value_max - value_min
    bound_lo = round(value_min + lo * span)
    bound_hi = round(value_min + hi * span)
    if level == LEVEL_MAX:
        bound_hi += 1
    value = int(rng.integers(bound_lo, max(bound_lo + 1, bound_hi)))
    if prob_negative and rng.random() < prob_negative:
        value = -value
    return value


def sample_float(level, value_min, value_max, rng) -> float:
    lo, hi = _level_window(level)
    span = value_max - value_min
    return rng.uniform(value_min + lo * span, value_min + hi * span)
