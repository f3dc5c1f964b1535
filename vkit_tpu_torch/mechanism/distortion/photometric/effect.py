"""Effect-family photometric ops (3): jpeg_quality, pixelation, fog.

Behavioral spec: vkit/mechanism/distortion/photometric/effect.py:26-216
(re-derived).  JPEG runs through the block-DCT codec simulation
(vkit_tpu/ops/effect), not a cv.imencode roundtrip; fog is a diamond-square
plasma fractal replayable from a frozen rng state.
"""
from typing import Any, Mapping, Optional, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ....element import Image, ImageMode
from ....ops import effect as effect_ops
from ....ops.resize_taps import Interpolation, resize_np
from ..interface import DistortionConfig
from .base import apply_in_rgb, clip_u8, photometric_op


@attr.define
class JpegQualityConfig(DistortionConfig):
    quality: int


@photometric_op(JpegQualityConfig)
def jpeg_quality(config: JpegQualityConfig, image: Image, rng) -> Image:
    assert 0 <= config.quality <= 100

    def codec(im: Image) -> Image:
        # The reference hands its RGB mat to cv.imencode, which reads it
        # as BGR — so luma/chroma derive from swapped channels.  Reproduce
        # by running the (bit-exact libjpeg) codec on the reversed order.
        from ....ops.jpeg_exact import jpeg_roundtrip_exact

        mat = im.mat[..., ::-1] if im.mat.ndim == 3 else im.mat
        out = jpeg_roundtrip_exact(np.ascontiguousarray(mat), config.quality)
        out = out[..., ::-1] if out.ndim == 3 else out
        return im.replace(mat=np.ascontiguousarray(out))

    return apply_in_rgb(image, codec)


@attr.define
class PixelationConfig(DistortionConfig):
    ratio: float


@photometric_op(PixelationConfig)
def pixelation(config: PixelationConfig, image: Image, rng) -> Image:
    assert 0 < config.ratio < 1
    small = resize_np(
        image.mat,
        (round(image.height * config.ratio), round(image.width * config.ratio)),
        Interpolation.LINEAR,
    )
    return image.replace(mat=resize_np(small, image.shape, Interpolation.NEAREST))


def generate_diamond_square_mask(
    shape: Tuple[int, int],
    roughness: float,
    rng: RandomGenerator,
) -> np.ndarray:
    """Plasma fractal in [0, 1] via diamond-square midpoint displacement.

    Start from a (2^n + 1) grid with random corners; at each scale, midpoints
    take the neighbor average lerped with fresh uniform noise by
    ``roughness**iteration``; finally crop a random window.
    """
    assert 0.0 <= roughness <= 1.0
    height, width = shape
    size = int(2**np.ceil(np.log2(max(height, width)))) + 1

    grid = np.zeros((size, size), dtype=np.float32)
    grid[0, 0], grid[0, -1], grid[-1, 0], grid[-1, -1] = rng.uniform(0, 1, 4)

    step = size - 1
    iteration = 0
    while step >= 2:
        half = step // 2
        rough = roughness**iteration

        # Diamond step: cell centers from 4 cell corners.
        corners = grid[0:size:step, 0:size:step]
        cell_avg = (
            corners[:-1, :-1] + corners[:-1, 1:] + corners[1:, :-1] + corners[1:, 1:]
        ) / 4.0
        centers = (1 - rough) * cell_avg + rough * rng.uniform(0, 1, cell_avg.shape)
        grid[half:size:step, half:size:step] = centers

        # Square step: edge midpoints from 2 corners + 2 centers (wrapped).
        m = centers.shape[0]
        wrap = np.arange(m + 1) % m
        wrap_prev = (np.arange(m + 1) - 1) % m

        two_corners = corners[:-1, :] + corners[1:, :]
        two_centers = centers[:, wrap] + centers[:, wrap_prev]
        mids_v = (1 - rough) * (two_corners + two_centers) / 4.0 \
            + rough * rng.uniform(0, 1, two_corners.shape)
        grid[half:size:step, 0:size:step] = mids_v

        two_corners = corners[:, :-1] + corners[:, 1:]
        two_centers = centers[wrap, :] + centers[wrap_prev, :]
        mids_h = (1 - rough) * (two_corners + two_centers) / 4.0 \
            + rough * rng.uniform(0, 1, two_corners.shape)
        grid[0:size:step, half:size:step] = mids_h

        step = half
        iteration += 1

    up = rng.integers(0, size - height + 1)
    left = rng.integers(0, size - width + 1)
    return grid[up:up + height, left:left + width]


@attr.define
class FogConfig(DistortionConfig):
    roughness: float
    fog_rgb: Tuple[int, int, int] = (226, 238, 234)
    ratio_max: float = 1.0
    ratio_min: float = 0.0
    rng_state: Optional[Mapping[str, Any]] = None


@photometric_op(FogConfig)
def fog(config: FogConfig, image: Image, rng) -> Image:
    assert rng is not None
    assert config.ratio_min < config.ratio_max

    def run(im: Image) -> Image:
        veil = generate_diamond_square_mask(im.shape, config.roughness, rng)
        veil = veil - veil.min()
        veil = veil / max(float(veil.max()), 1e-6)
        veil = veil * (config.ratio_max - config.ratio_min) + config.ratio_min

        mat = im.mat.astype(np.float32)
        if im.mode == ImageMode.GRAYSCALE:
            r, g, b = config.fog_rgb
            luminance = 0.2126 * r + 0.7152 * g + 0.0722 * b
            mat = (1 - veil) * mat + veil * luminance
        else:
            assert im.mode == ImageMode.RGB
            tint = np.asarray(config.fog_rgb, dtype=np.float32)
            mat = (1 - veil[..., None]) * mat + veil[..., None] * tint
        return im.replace(mat=clip_u8(mat))

    return apply_in_rgb(image, run)
