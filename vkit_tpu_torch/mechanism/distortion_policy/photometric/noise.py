"""Noise policy samplers (4).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/photometric/noise.py); sampling re-derived.
"""
import attr

from ....mechanism import distortion
from ..opt import sample_float
from ..type import policy_factory


@attr.define
class GaussionNoiseConfigGeneratorConfig:
    std_min: float = 1.0
    std_max: float = 35.0


@policy_factory(distortion.gaussion_noise, GaussionNoiseConfigGeneratorConfig)
def gaussion_noise_policy_factory(knobs, level, shape, rng):
    return dict(std=sample_float(level, knobs.std_min, knobs.std_max, None, rng))


@attr.define
class PoissonNoiseConfigGeneratorConfig:
    pass


@policy_factory(distortion.poisson_noise, PoissonNoiseConfigGeneratorConfig)
def poisson_noise_policy_factory(knobs, level, shape, rng):
    return {}


@attr.define
class ImpulseNoiseConfigGeneratorConfig:
    prob_presv_min: float = 0.95
    prob_presv_max: float = 1.0


@policy_factory(distortion.impulse_noise, ImpulseNoiseConfigGeneratorConfig)
def impulse_noise_policy_factory(knobs, level, shape, rng):
    prob_keep = sample_float(level, knobs.prob_presv_min, knobs.prob_presv_max,
                             None, rng, inverse_level=True)
    budget = 1 - prob_keep
    prob_salt = budget * rng.uniform()
    return dict(prob_salt=prob_salt, prob_pepper=budget - prob_salt)


@attr.define
class SpeckleNoiseConfigGeneratorConfig:
    std_min: float = 0.0
    std_max: float = 0.3


@policy_factory(distortion.speckle_noise, SpeckleNoiseConfigGeneratorConfig)
def speckle_noise_policy_factory(knobs, level, shape, rng):
    return dict(std=sample_float(level, knobs.std_min, knobs.std_max, None, rng))
