"""Shared plumbing for the photometric catalog.

Every photometric op is a plain function ``apply(config, image, rng) ->
Image`` wrapped into a PhotometricDistortion.  The combinators here factor
out the three recurring shapes: per-channel mat math, an RGB detour for
ops that only understand RGB/GRAYSCALE, and a tone detour through HSV/HSL.

Behavioral spec: vkit/mechanism/distortion/photometric/opt.py (re-derived).
"""
from enum import Enum, unique
from typing import Callable, Optional, Sequence

import numpy as np

from ....element import Image, ImageMode
from ..interface import PhotometricDistortion


@unique
class OutOfBoundBehavior(Enum):
    CLIP = 'clip'
    CYCLE = 'cycle'


def to_u8(xp, mat, oob: OutOfBoundBehavior):
    """Round and fold an intermediate mat back into uint8."""
    mat = xp.round(mat)
    if oob is OutOfBoundBehavior.CLIP:
        return xp.clip(mat, 0, 255).astype(xp.uint8)
    if oob is OutOfBoundBehavior.CYCLE:
        return (mat % 256).astype(xp.uint8)
    raise NotImplementedError(oob)


def clip_u8(mat: np.ndarray) -> np.ndarray:
    return np.clip(mat, 0, 255).astype(np.uint8)


def apply_channelwise(
    image: Image,
    channels: Optional[Sequence[int]],
    dtype,
    fn: Callable[[np.ndarray], np.ndarray],
) -> Image:
    """Run `fn` over the selected channels (or the full mat) and reassemble."""
    mat = image.mat
    if channels:
        mat = mat[:, :, list(channels)]
    out = np.asarray(fn(mat.astype(dtype)))
    if channels:
        patched = image.copy()
        with patched.writable_context:
            patched.mat[:, :, list(channels)] = out
        return patched
    assert out.shape == image.mat.shape
    return image.replace(mat=out)


def apply_in_rgb(image: Image, fn: Callable[[Image], Image]) -> Image:
    """Detour through RGB for ops that only understand RGB/GRAYSCALE."""
    mode = image.mode
    plain = mode in (ImageMode.GRAYSCALE, ImageMode.RGB)
    work = image if plain else image.to_rgb_image()
    out = fn(work)
    return out if plain else out.to_target_mode_image(mode)


def apply_in_tone_space(
    image: Image,
    channel: int,
    delta: int,
    oob: OutOfBoundBehavior,
    intermediate: ImageMode = ImageMode.HSV,
) -> Image:
    """Shift one HSV/HSL channel, converting through `intermediate` if the
    image is not already in a tone space."""
    mode = image.mode
    in_tone = mode in (ImageMode.HSV, ImageMode.HSL)
    work = image if in_tone else image.to_target_mode_image(intermediate)
    shifted = apply_channelwise(
        work, [channel], np.int16, lambda m: to_u8(np, m + delta, oob)
    )
    return shifted if in_tone else shifted.to_target_mode_image(mode)


def photometric_op(config_cls):
    """Decorator: apply(config, image, rng) -> PhotometricDistortion."""

    def wrap(apply_fn) -> PhotometricDistortion:
        return PhotometricDistortion(config_cls, apply_fn)

    return wrap
