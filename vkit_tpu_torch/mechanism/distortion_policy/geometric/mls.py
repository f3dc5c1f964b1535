"""Similarity-MLS policy sampler: corner-pinned control lattice with
level-scaled random handle offsets.

Parameter table matches the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/geometric/mls.py:27-111); sampling
re-derived.
"""
from typing import List

import attr
from numpy.random import Generator as RandomGenerator

from ....element import Point, PointTuple
from ....mechanism import distortion
from ..opt import SampleFloatMode, generate_grid_size, sample_float
from ..type import policy_factory


@attr.define
class SimilarityMlsConfigGeneratorConfig:
    num_segments_min: int = 2
    num_segments_max: int = 4
    step_min: int = 10
    radius_max_ratio_min: float = 0.025
    radius_max_ratio_max: float = 0.125
    grid_size_min: int = 15
    grid_size_ratio: float = 0.01


def _axis_coords(length: int, step: int, rng: RandomGenerator) -> List[int]:
    """Coordinates covering [0, length-1] in shuffled ~step jumps."""
    end = length - 1
    jumps = [step] * (end // step)
    remainder = end % step
    if remainder:
        # Fold the remainder into the last jump.
        jumps = jumps[:-1] + [step + remainder] if len(jumps) > 1 else [end]
    assert sum(jumps) == end
    rng.shuffle(jumps)
    coords = [0]
    for jump in jumps:
        coords.append(coords[-1] + jump)
    return coords


@policy_factory(distortion.similarity_mls, SimilarityMlsConfigGeneratorConfig)
def similarity_mls_policy_factory(knobs, level, shape, rng):
    height, width = shape
    num_segments = int(rng.integers(knobs.num_segments_min, knobs.num_segments_max + 1))
    step = (min(shape) - 1) // num_segments
    if step < knobs.step_min:
        # Too tight: degrade to corners only.
        step = min(shape) - 1

    ys = _axis_coords(height, step, rng)
    xs = _axis_coords(width, step, rng)
    src_handles = [Point.create(y=y, x=x) for y in ys for x in xs]

    assert knobs.radius_max_ratio_max < 0.5
    radius_ratio = sample_float(
        level, knobs.radius_max_ratio_min, knobs.radius_max_ratio_max, None, rng,
        mode=SampleFloatMode.QUAD,
    )
    radius = int(radius_ratio * step)
    dst_handles = [
        Point.create(
            y=pt.y + int(rng.integers(-radius, radius + 1)),
            x=pt.x + int(rng.integers(-radius, radius + 1)),
        ) for pt in src_handles
    ]

    return dict(
        src_handle_points=PointTuple(src_handles),
        dst_handle_points=PointTuple(dst_handles),
        grid_size=generate_grid_size(knobs.grid_size_min, knobs.grid_size_ratio, shape),
    )
