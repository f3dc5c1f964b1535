"""Effect policy samplers (3).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/photometric/effect.py); sampling re-derived.
"""
import attr

from ....mechanism import distortion
from ..opt import sample_float, sample_int
from ..type import policy_factory


@attr.define
class JpegQualityConfigGeneratorConfig:
    quality_min: int = 1
    quality_max: int = 50


@policy_factory(distortion.jpeg_quality, JpegQualityConfigGeneratorConfig)
def jpeg_quality_policy_factory(knobs, level, shape, rng):
    quality = sample_int(level, knobs.quality_min, knobs.quality_max, None, rng,
                         inverse_level=True)
    return dict(quality=quality)


@attr.define
class PixelationConfigGeneratorConfig:
    ratio_min: float = 0.3
    ratio_max: float = 1.0


@policy_factory(distortion.pixelation, PixelationConfigGeneratorConfig)
def pixelation_policy_factory(knobs, level, shape, rng):
    ratio = sample_float(level, knobs.ratio_min, knobs.ratio_max, None, rng,
                         inverse_level=True)
    return dict(ratio=ratio)


@attr.define
class FogConfigGeneratorConfig:
    roughness_min: float = 0.2
    roughness_max: float = 0.85
    ratio_max_min: float = 0.2
    ratio_max_max: float = 0.75


@policy_factory(distortion.fog, FogConfigGeneratorConfig)
def fog_policy_factory(knobs, level, shape, rng):
    return dict(
        roughness=sample_float(level, knobs.roughness_min, knobs.roughness_max,
                               None, rng),
        ratio_max=sample_float(level, knobs.ratio_max_min, knobs.ratio_max_max,
                               None, rng),
    )
