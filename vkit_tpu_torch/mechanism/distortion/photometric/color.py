"""Color-family photometric ops (10).

Behavioral spec: vkit/mechanism/distortion/photometric/color.py:32-439
(re-derived around the base.py combinators).
"""
from typing import Any, Mapping, Optional, Sequence

import attr
import numpy as np

from ....element import Image, ImageMode
from ....ops import colorspace_np as csp
from ..interface import DistortionConfig
from .base import (
    OutOfBoundBehavior,
    apply_channelwise,
    apply_in_tone_space,
    clip_u8,
    photometric_op,
    to_u8,
)


@attr.define
class MeanShiftConfig(DistortionConfig):
    delta: int
    threshold: Optional[int] = None
    channels: Optional[Sequence[int]] = None
    oob_behavior: OutOfBoundBehavior = OutOfBoundBehavior.CLIP


def shift_mat(mat: np.ndarray, delta: int, threshold: Optional[int],
              oob: OutOfBoundBehavior) -> np.ndarray:
    """Add delta; with a threshold, shift only values on its near side."""
    if threshold is None:
        shifted = mat + delta
    elif delta > 0:
        shifted = np.where(mat <= threshold, mat + delta, mat)
    else:
        shifted = np.where(mat >= threshold, mat + delta, mat)
    return to_u8(np, shifted, oob)


@photometric_op(MeanShiftConfig)
def mean_shift(config: MeanShiftConfig, image: Image, rng) -> Image:
    if config.delta == 0:
        return image
    return apply_channelwise(
        image, config.channels, np.int16,
        lambda m: shift_mat(m, config.delta, config.threshold, config.oob_behavior),
    )


@attr.define
class ColorShiftConfig(DistortionConfig):
    delta: int


@photometric_op(ColorShiftConfig)
def color_shift(config: ColorShiftConfig, image: Image, rng) -> Image:
    # Hue rotates cyclically.
    return apply_in_tone_space(
        image, channel=0, delta=config.delta, oob=OutOfBoundBehavior.CYCLE,
    )


@attr.define
class BrightnessShiftConfig(DistortionConfig):
    delta: int
    intermediate_image_mode: ImageMode = ImageMode.HSL


@photometric_op(BrightnessShiftConfig)
def brightness_shift(config: BrightnessShiftConfig, image: Image, rng) -> Image:
    assert config.intermediate_image_mode in (ImageMode.HSV, ImageMode.HSL)
    return apply_in_tone_space(
        image, channel=2, delta=config.delta, oob=OutOfBoundBehavior.CLIP,
        intermediate=config.intermediate_image_mode,
    )


@attr.define
class StdShiftConfig(DistortionConfig):
    scale: float
    channels: Optional[Sequence[int]] = None


@photometric_op(StdShiftConfig)
def std_shift(config: StdShiftConfig, image: Image, rng) -> Image:
    assert config.scale > 0

    def scale_about_mean(mat: np.ndarray) -> np.ndarray:
        axis = None if mat.ndim == 2 else (0, 1)
        mean = mat.mean(axis=axis)
        return to_u8(np, mat * config.scale - mean * (config.scale - 1),
                     OutOfBoundBehavior.CLIP)

    return apply_channelwise(image, config.channels, np.float32, scale_about_mean)


@attr.define
class BoundaryEqualizationConfig(DistortionConfig):
    channels: Optional[Sequence[int]] = None


@photometric_op(BoundaryEqualizationConfig)
def boundary_equalization(config: BoundaryEqualizationConfig, image: Image,
                          rng) -> Image:

    def stretch(mat: np.ndarray) -> np.ndarray:
        axis = None if mat.ndim == 2 else (0, 1)
        lo = mat.min(axis=axis)
        span = mat.max(axis=axis) - lo
        out = np.where(span > 0, (mat - lo) * (255.0 / np.maximum(span, 1e-6)), mat)
        return to_u8(np, out, OutOfBoundBehavior.CLIP)

    return apply_channelwise(image, config.channels, np.float32, stretch)


@attr.define
class HistogramEqualizationConfig(DistortionConfig):
    channels: Optional[Sequence[int]] = None


@photometric_op(HistogramEqualizationConfig)
def histogram_equalization(config: HistogramEqualizationConfig, image: Image,
                           rng) -> Image:

    def equalize(mat: np.ndarray) -> np.ndarray:
        if mat.ndim == 2:
            return csp.equalize_hist(mat)
        return np.dstack([
            csp.equalize_hist(mat[:, :, idx]) for idx in range(mat.shape[-1])
        ])

    return apply_channelwise(image, config.channels, np.uint8, equalize)


@attr.define
class ComplementConfig(DistortionConfig):
    threshold: Optional[int] = None
    enable_threshold_lte: bool = False
    channels: Optional[Sequence[int]] = None


@photometric_op(ComplementConfig)
def complement(config: ComplementConfig, image: Image, rng) -> Image:
    if config.threshold is not None:
        assert 0 <= config.threshold <= 255

    def invert(mat: np.ndarray) -> np.ndarray:
        if config.threshold is None:
            return (255 - mat).astype(np.uint8)
        gate = (mat <= config.threshold) if config.enable_threshold_lte \
            else (mat >= config.threshold)
        return np.where(gate, 255 - mat, mat).astype(np.uint8)

    return apply_channelwise(image, config.channels, np.uint8, invert)


@attr.define
class PosterizationConfig(DistortionConfig):
    num_bits: int
    channels: Optional[Sequence[int]] = None


@photometric_op(PosterizationConfig)
def posterization(config: PosterizationConfig, image: Image, rng) -> Image:
    assert 0 <= config.num_bits < 8
    if config.num_bits == 0:
        return image
    keep = np.uint8((0xFF >> config.num_bits) << config.num_bits)
    return apply_channelwise(
        image, config.channels, np.uint8, lambda m: (m & keep).astype(np.uint8)
    )


@attr.define
class ColorBalanceConfig(DistortionConfig):
    ratio: float


@photometric_op(ColorBalanceConfig)
def color_balance(config: ColorBalanceConfig, image: Image, rng) -> Image:
    """Lerp toward the image's own grayscale rendition."""
    assert 0.0 <= config.ratio <= 1.0
    if image.mode == ImageMode.GRAYSCALE:
        return image

    gray = image.to_grayscale_image().to_target_mode_image(image.mode)
    # In tone spaces, hue stays; only saturation + lightness move.
    channels = [1, 2] if image.mode in (ImageMode.HSV, ImageMode.HSL) else None

    def lerp(mat: np.ndarray) -> np.ndarray:
        other = gray.mat[:, :, channels] if channels else gray.mat
        mixed = (1 - config.ratio) * other.astype(np.float32) + config.ratio * mat
        return clip_u8(mixed)

    return apply_channelwise(image, channels, np.float32, lerp)


@attr.define
class ChannelPermutationConfig(DistortionConfig):
    rng_state: Optional[Mapping[str, Any]] = None


@photometric_op(ChannelPermutationConfig)
def channel_permutation(config: ChannelPermutationConfig, image: Image, rng) -> Image:
    assert rng is not None
    order = rng.permutation(image.num_channels)
    return image.replace(mat=image.mat[:, :, order])
