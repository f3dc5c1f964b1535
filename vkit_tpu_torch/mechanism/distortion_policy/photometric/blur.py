"""Blur policy samplers (5).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/photometric/blur.py); sampling re-derived.
"""
import attr

from ....mechanism import distortion
from ..opt import sample_float, sample_int
from ..type import policy_factory


@attr.define
class GaussianBlurConfigGeneratorConfig:
    sigma_min: float = 0.5
    sigma_max: float = 1.0


@policy_factory(distortion.gaussian_blur, GaussianBlurConfigGeneratorConfig)
def gaussian_blur_policy_factory(knobs, level, shape, rng):
    return dict(sigma=sample_float(level, knobs.sigma_min, knobs.sigma_max, None, rng))


@attr.define
class DefocusBlurConfigGeneratorConfig:
    radius_min: int = 1
    radius_max: int = 2


@policy_factory(distortion.defocus_blur, DefocusBlurConfigGeneratorConfig)
def defocus_blur_policy_factory(knobs, level, shape, rng):
    return dict(radius=sample_int(level, knobs.radius_min, knobs.radius_max, None, rng))


@attr.define
class MotionBlurConfigGeneratorConfig:
    radius_min: int = 1
    radius_max: int = 2


@policy_factory(distortion.motion_blur, MotionBlurConfigGeneratorConfig)
def motion_blur_policy_factory(knobs, level, shape, rng):
    radius = sample_int(level, knobs.radius_min, knobs.radius_max, None, rng)
    return dict(radius=radius, angle=int(rng.integers(0, 360)))


@attr.define
class GlassBlurConfigGeneratorConfig:
    sigma_min: float = 0.5
    sigma_max: float = 1.0
    delta_min: int = 1
    delta_max: int = 1
    loop_min: int = 1
    loop_max: int = 4


@policy_factory(distortion.glass_blur, GlassBlurConfigGeneratorConfig)
def glass_blur_policy_factory(knobs, level, shape, rng):
    return dict(
        sigma=sample_float(level, knobs.sigma_min, knobs.sigma_max, None, rng),
        delta=sample_int(level, knobs.delta_min, knobs.delta_max, None, rng),
        loop=sample_int(level, knobs.loop_min, knobs.loop_max, None, rng),
    )


@attr.define
class ZoomInBlurConfigGeneratorConfig:
    ratio_min: float = 0.01
    ratio_max: float = 0.1
    step_min: float = 0.002
    step_max: float = 0.02
    alpha_min: float = 0.5
    alpha_max: float = 0.7


@policy_factory(distortion.zoom_in_blur, ZoomInBlurConfigGeneratorConfig)
def zoom_in_blur_policy_factory(knobs, level, shape, rng):
    return dict(
        ratio=sample_float(level, knobs.ratio_min, knobs.ratio_max, None, rng),
        step=sample_float(level, knobs.step_min, knobs.step_max, None, rng),
        alpha=rng.uniform(knobs.alpha_min, knobs.alpha_max),
    )
