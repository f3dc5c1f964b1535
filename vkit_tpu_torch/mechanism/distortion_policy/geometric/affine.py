"""Affine policy samplers (5).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/geometric/affine.py); sampling re-derived.
"""
import attr

from ....mechanism import distortion
from ..opt import sample_float, sample_int
from ..type import policy_factory


@attr.define
class ShearHoriConfigGeneratorConfig:
    angle_min: int = 1
    angle_max: int = 30
    prob_negative: float = 0.5


@policy_factory(distortion.shear_hori, ShearHoriConfigGeneratorConfig)
def shear_hori_policy_factory(knobs, level, shape, rng):
    return dict(angle=sample_int(level, knobs.angle_min, knobs.angle_max,
                                 knobs.prob_negative, rng))


@attr.define
class ShearVertConfigGeneratorConfig:
    angle_min: int = 1
    angle_max: int = 30
    prob_negative: float = 0.5


@policy_factory(distortion.shear_vert, ShearVertConfigGeneratorConfig)
def shear_vert_policy_factory(knobs, level, shape, rng):
    return dict(angle=sample_int(level, knobs.angle_min, knobs.angle_max,
                                 knobs.prob_negative, rng))


@attr.define
class RotateConfigGeneratorConfig:
    angle_min: int = 1
    angle_max: int = 180
    prob_negative: float = 0.5


@policy_factory(distortion.rotate, RotateConfigGeneratorConfig)
def rotate_policy_factory(knobs, level, shape, rng):
    return dict(angle=sample_int(level, knobs.angle_min, knobs.angle_max,
                                 knobs.prob_negative, rng))


def _sample_skew_ratio(knobs, level, rng) -> float:
    ratio = sample_float(level, knobs.ratio_min, knobs.ratio_max, None, rng)
    return -ratio if rng.random() < knobs.prob_negative else ratio


@attr.define
class SkewHoriConfigGeneratorConfig:
    ratio_min: float = 0.0
    ratio_max: float = 0.35
    prob_negative: float = 0.5


@policy_factory(distortion.skew_hori, SkewHoriConfigGeneratorConfig)
def skew_hori_policy_factory(knobs, level, shape, rng):
    return dict(ratio=_sample_skew_ratio(knobs, level, rng))


@attr.define
class SkewVertConfigGeneratorConfig:
    ratio_min: float = 0.0
    ratio_max: float = 0.35
    prob_negative: float = 0.5


@policy_factory(distortion.skew_vert, SkewVertConfigGeneratorConfig)
def skew_vert_policy_factory(knobs, level, shape, rng):
    return dict(ratio=_sample_skew_ratio(knobs, level, rng))
