"""Level -> parameter sampling helpers.

Semantics contract (vkit/mechanism/distortion_policy/opt.py:14-130,
re-derived): a level in [1, 10] selects the level-th sub-window of the
value range; LINEAR slices uniformly, QUAD through -x^2 + 2x (front-loaded);
``inverse_level`` flips severity; negative/reciprocal flips apply after.
"""
from enum import Enum, auto
from typing import Optional, Tuple

from numpy.random import Generator as RandomGenerator

from ...utility import rng_choice_with_size

LEVEL_MIN = 1
LEVEL_MAX = 10
CHANNELS = [0, 1, 2]


class SampleFloatMode(Enum):
    LINEAR = auto()
    QUAD = auto()


def _level_window(level: int, inverse: bool, mode: SampleFloatMode
                  ) -> Tuple[float, float]:
    if inverse:
        level = LEVEL_MAX + 1 - level
    lo = (level - 1) / LEVEL_MAX
    hi = level / LEVEL_MAX
    if mode is SampleFloatMode.QUAD:
        lo = -lo * lo + 2 * lo
        hi = -hi * hi + 2 * hi
    return lo, hi


def func_quad(x: float) -> float:
    return -x * x + 2 * x


def sample_int(level: int, value_min: int, value_max: int,
               prob_negative: Optional[float], rng: RandomGenerator,
               inverse_level: bool = False) -> int:
    lo, hi = _level_window(level, inverse_level, SampleFloatMode.LINEAR)
    span = value_max - value_min
    bound_lo = round(value_min + lo * span)
    bound_hi = round(value_min + hi * span)
    if (LEVEL_MAX + 1 - level if inverse_level else level) == LEVEL_MAX:
        bound_hi += 1
    value = int(rng.integers(bound_lo, max(bound_lo + 1, bound_hi)))
    if prob_negative and rng.random() < prob_negative:
        value = -value
    return value


def sample_float(level: int, value_min: float, value_max: float,
                 prob_reciprocal: Optional[float], rng: RandomGenerator,
                 mode: SampleFloatMode = SampleFloatMode.LINEAR,
                 inverse_level: bool = False) -> float:
    lo, hi = _level_window(level, inverse_level, mode)
    span = value_max - value_min
    value = rng.uniform(value_min + lo * span, value_min + hi * span)
    if prob_reciprocal and rng.random() < prob_reciprocal:
        value = 1 / value
    return value


def sample_channels(rng: RandomGenerator):
    """None (all channels) 1/3 of the time; else a sorted random subset."""
    count = int(rng.integers(1, 4))
    if count == 3:
        return None
    return sorted(rng_choice_with_size(rng, CHANNELS, count, replace=False))


def generate_grid_size(grid_size_min: int, grid_size_ratio: float,
                       shape: Tuple[int, int]) -> int:
    return max(grid_size_min, int(grid_size_ratio * max(shape)))
