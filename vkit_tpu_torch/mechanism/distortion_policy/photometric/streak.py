"""Streak policy samplers (3).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/photometric/streak.py); sampling re-derived.
"""
import attr

from ....mechanism import distortion
from ..opt import sample_float
from ..type import policy_factory


def _sample_dash(knobs, long_side: int, rng):
    if rng.random() >= knobs.prob_dash:
        return 0, 0
    thickness_ratio = float(rng.uniform(
        knobs.dash_thickness_ratio_min, knobs.dash_thickness_ratio_max
    ))
    dash_thickness = round(thickness_ratio * long_side)
    gap_ratio = float(rng.uniform(
        knobs.dash_to_thickness_gap_ratio_min, knobs.dash_to_thickness_gap_ratio_max
    ))
    return dash_thickness, round(gap_ratio * dash_thickness)


def _sample_concentric(knobs, level, shape, rng):
    """Shared thickness / aspect / short-side geometry for rect + ellipse."""
    long_side = max(shape)
    min_ratio = sample_float(level, knobs.short_side_min_ratio_min,
                             knobs.short_side_min_ratio_max, None, rng,
                             inverse_level=True)
    short_side_min = max(knobs.short_side_min, round(min_ratio * long_side))
    step_ratio = rng.uniform(knobs.short_side_step_ratio_min,
                             knobs.short_side_step_ratio_max)
    return dict(
        thickness=int(rng.integers(knobs.thickness_min, knobs.thickness_max + 1)),
        aspect_ratio=rng.uniform(knobs.aspect_ratio_min, knobs.aspect_ratio_max),
        short_side_min=short_side_min,
        short_side_step=round(step_ratio * short_side_min),
        alpha=rng.uniform(knobs.alpha_min, knobs.alpha_max),
    )


@attr.define
class LineStreakConfigGeneratorConfig:
    thickness_min: int = 1
    thickness_max: int = 4
    gap_min: int = 5
    gap_ratio_min: float = 0.01
    gap_ratio_max: float = 0.5
    prob_dash: float = 0.25
    dash_thickness_ratio_min: float = 0.0
    dash_thickness_ratio_max: float = 0.05
    dash_to_thickness_gap_ratio_min: float = 0.5
    dash_to_thickness_gap_ratio_max: float = 1.0
    alpha_min: float = 0.2
    alpha_max: float = 1.0


@policy_factory(distortion.line_streak, LineStreakConfigGeneratorConfig)
def line_streak_policy_factory(knobs, level, shape, rng):
    long_side = max(shape)
    gap_ratio = sample_float(level, knobs.gap_ratio_min, knobs.gap_ratio_max,
                             None, rng, inverse_level=True)
    gap = max(knobs.gap_min, round(gap_ratio * long_side))
    thickness = int(rng.integers(knobs.thickness_min, knobs.thickness_max + 1))
    dash_thickness, dash_gap = _sample_dash(knobs, long_side, rng)
    alpha = rng.uniform(knobs.alpha_min, knobs.alpha_max)
    orientation = rng.integers(0, 3)  # 0: vert, 1: hori, 2: both
    return dict(
        thickness=thickness,
        gap=gap,
        dash_thickness=dash_thickness,
        dash_gap=dash_gap,
        alpha=alpha,
        enable_vert=orientation in (0, 2),
        enable_hori=orientation in (1, 2),
    )


@attr.define
class RectangleStreakConfigGeneratorConfig:
    thickness_min: int = 1
    thickness_max: int = 4
    aspect_ratio_min: float = 0.5
    aspect_ratio_max: float = 1.5
    prob_dash: float = 0.25
    dash_thickness_ratio_min: float = 0.0
    dash_thickness_ratio_max: float = 0.05
    dash_to_thickness_gap_ratio_min: float = 0.5
    dash_to_thickness_gap_ratio_max: float = 1.0
    short_side_min: int = 5
    short_side_min_ratio_min: float = 0.01
    short_side_min_ratio_max: float = 0.25
    short_side_step_ratio_min: float = 0.8
    short_side_step_ratio_max: float = 3.0
    alpha_min: float = 0.2
    alpha_max: float = 1.0


@policy_factory(distortion.rectangle_streak, RectangleStreakConfigGeneratorConfig)
def rectangle_streak_policy_factory(knobs, level, shape, rng):
    params = _sample_concentric(knobs, level, shape, rng)
    dash_thickness, dash_gap = _sample_dash(knobs, max(shape), rng)
    params.update(dash_thickness=dash_thickness, dash_gap=dash_gap)
    return params


@attr.define
class EllipseStreakConfigGeneratorConfig:
    thickness_min: int = 1
    thickness_max: int = 3
    aspect_ratio_min: float = 0.5
    aspect_ratio_max: float = 1.5
    short_side_min: int = 5
    short_side_min_ratio_min: float = 0.01
    short_side_min_ratio_max: float = 0.25
    short_side_step_ratio_min: float = 0.8
    short_side_step_ratio_max: float = 3.0
    alpha_min: float = 0.2
    alpha_max: float = 1.0


@policy_factory(distortion.ellipse_streak, EllipseStreakConfigGeneratorConfig)
def ellipse_streak_policy_factory(knobs, level, shape, rng):
    return _sample_concentric(knobs, level, shape, rng)
