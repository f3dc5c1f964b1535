"""Color policy samplers (10).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/photometric/color.py); the sampling logic
is re-derived as plain functions.
"""
import attr

from ....mechanism import distortion
from ..opt import LEVEL_MAX, sample_channels, sample_float, sample_int
from ..type import policy_factory


@attr.define
class MeanShiftConfigGeneratorConfig:
    delta_max: int = 127
    prob_negative: float = 0.5
    prob_enable_threshold: float = 0.5
    threshold_ratio_min: float = 1.0
    threshold_ratio_max: float = 1.5


@policy_factory(distortion.mean_shift, MeanShiftConfigGeneratorConfig)
def mean_shift_policy_factory(knobs, level, shape, rng):
    delta = sample_int(level, 0, knobs.delta_max, knobs.prob_negative, rng)
    channels = sample_channels(rng)
    threshold = None
    if rng.random() < knobs.prob_enable_threshold:
        ratio = rng.uniform(knobs.threshold_ratio_min, knobs.threshold_ratio_max)
        # Gate so the shift cannot wrap: only headroom-side values move.
        threshold = round(-delta * ratio) if delta < 0 else round(255 - delta * ratio)
    return dict(delta=delta, channels=channels, threshold=threshold)


@attr.define
class ColorShiftConfigGeneratorConfig:
    delta_max: int = 127
    prob_negative: float = 0.5


@policy_factory(distortion.color_shift, ColorShiftConfigGeneratorConfig)
def color_shift_policy_factory(knobs, level, shape, rng):
    return dict(delta=sample_int(level, 0, knobs.delta_max, knobs.prob_negative, rng))


@attr.define
class BrightnessShiftConfigGeneratorConfig:
    delta_max: int = 127
    prob_negative: float = 0.5


@policy_factory(distortion.brightness_shift, BrightnessShiftConfigGeneratorConfig)
def brightness_shift_policy_factory(knobs, level, shape, rng):
    return dict(delta=sample_int(level, 0, knobs.delta_max, knobs.prob_negative, rng))


@attr.define
class StdShiftConfigGeneratorConfig:
    scale_min: float = 1.0
    scale_max: float = 2.5
    prob_reciprocal: float = 0.5


@policy_factory(distortion.std_shift, StdShiftConfigGeneratorConfig)
def std_shift_policy_factory(knobs, level, shape, rng):
    scale = sample_float(level, knobs.scale_min, knobs.scale_max,
                         knobs.prob_reciprocal, rng)
    return dict(scale=scale, channels=sample_channels(rng))


@attr.define
class BoundaryEqualizationConfigGeneratorConfig:
    pass


@policy_factory(distortion.boundary_equalization, BoundaryEqualizationConfigGeneratorConfig)
def boundary_equalization_policy_factory(knobs, level, shape, rng):
    return dict(channels=sample_channels(rng))


@attr.define
class HistogramEqualizationConfigGeneratorConfig:
    pass


@policy_factory(distortion.histogram_equalization, HistogramEqualizationConfigGeneratorConfig)
def histogram_equalization_policy_factory(knobs, level, shape, rng):
    return dict(channels=sample_channels(rng))


@attr.define
class ComplementConfigGeneratorConfig:
    enable_threshold_level: int = 6
    threshold_min: int = 77
    threshold_max: int = 177


@policy_factory(distortion.complement, ComplementConfigGeneratorConfig)
def complement_policy_factory(knobs, level, shape, rng):
    channels = sample_channels(rng)
    enable_threshold_lte = rng.random() < 0.5
    threshold = None
    if level >= knobs.enable_threshold_level:
        threshold = int(rng.integers(knobs.threshold_min, knobs.threshold_max + 1))
    return dict(threshold=threshold, enable_threshold_lte=enable_threshold_lte,
                channels=channels)


@attr.define
class PosterizationConfigGeneratorConfig:
    enable_threshold_level: int = 6
    threshold_min: int = 77
    threshold_max: int = 177


@policy_factory(distortion.posterization, PosterizationConfigGeneratorConfig)
def posterization_policy_factory(knobs, level, shape, rng):
    # Level maps linearly onto [1, 7] cleared bits.
    return dict(num_bits=round(level / LEVEL_MAX * 7), channels=sample_channels(rng))


@attr.define
class ColorBalanceConfigGeneratorConfig:
    ratio_min: float = 0.0
    ratio_max: float = 1.0


@policy_factory(distortion.color_balance, ColorBalanceConfigGeneratorConfig)
def color_balance_policy_factory(knobs, level, shape, rng):
    ratio = sample_float(level, knobs.ratio_min, knobs.ratio_max, None, rng,
                         inverse_level=True)
    return dict(ratio=ratio)


@attr.define
class ChannelPermutationConfigGeneratorConfig:
    pass


@policy_factory(distortion.channel_permutation, ChannelPermutationConfigGeneratorConfig)
def channel_permutation_policy_factory(knobs, level, shape, rng):
    return {}
