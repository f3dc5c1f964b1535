"""Blur-family photometric ops (5).

Behavioral spec: vkit/mechanism/distortion/photometric/blur.py:26-330
(re-derived).  Convolution kernels are built analytically host-side and run
through the kernel library (vkit_tpu/ops/blur); glass blur's pixel-swap
permutation replays from a frozen rng state.
"""
from typing import Any, Mapping, Optional, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ....element import Image
from ....ops import blur as blur_ops
from ....ops.resize_taps import Interpolation, resize_np
from ..interface import DistortionConfig
from .base import apply_in_rgb, clip_u8, photometric_op


def estimate_gaussian_kernel_size(sigma: float) -> int:
    """Odd kernel size covering ~3 sigma."""
    ksize = max(3, round(3 * sigma) + 1)
    return ksize + 1 if ksize % 2 == 0 else ksize


def _smooth_kernel(kernel: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian anti-alias pass over a conv kernel.

    Reflect-101 padding on purpose: the reference anti-aliases through
    cv.GaussianBlur, whose default border DOUBLES edge mass (the smoothed
    kernel sums to ~1.03) and it never renormalizes — that brightness gain
    is observable output behavior, so it is reproduced here.
    """
    ksize = estimate_gaussian_kernel_size(sigma)
    taps = blur_ops.gaussian_kernel1d(sigma, ksize).astype(np.float64)
    half = ksize // 2
    padded = np.pad(kernel.astype(np.float64), half, mode='reflect')
    out = np.apply_along_axis(lambda r: np.convolve(r, taps, mode='same'), 1, padded)
    out = np.apply_along_axis(lambda c: np.convolve(c, taps, mode='same'), 0, out)
    return out[half:-half, half:-half].astype(np.float32)


def _padded_kernel_size(radius: int, aa_sigma: float) -> int:
    pad = estimate_gaussian_kernel_size(aa_sigma) // 2 * 2
    return 2 * radius + 1 + pad


@attr.define
class GaussianBlurConfig(DistortionConfig):
    sigma: float


@photometric_op(GaussianBlurConfig)
def gaussian_blur(config: GaussianBlurConfig, image: Image, rng) -> Image:
    ksize = estimate_gaussian_kernel_size(config.sigma)
    return apply_in_rgb(
        image,
        lambda im: im.replace(mat=blur_ops.gaussian_blur_np(im.mat, config.sigma, ksize)),
    )


@attr.define
class DefocusBlurConfig(DistortionConfig):
    radius: int
    anti_aliasing_sigma: float = 0.5


@photometric_op(DefocusBlurConfig)
def defocus_blur(config: DefocusBlurConfig, image: Image, rng) -> Image:
    assert config.radius > 0
    ksize = _padded_kernel_size(config.radius, config.anti_aliasing_sigma)
    half = ksize // 2
    axis = np.arange(-half, -half + ksize)
    disk = (
        (axis[None, :]**2 + axis[:, None]**2) <= config.radius**2
    ).astype(np.float32)
    disk /= disk.sum()
    kernel = _smooth_kernel(disk, config.anti_aliasing_sigma)
    return apply_in_rgb(
        image, lambda im: im.replace(mat=blur_ops.filter2d_np(im.mat, kernel))
    )


@attr.define
class MotionBlurConfig(DistortionConfig):
    radius: int
    angle: int
    anti_aliasing_sigma: float = 0.5


def _rotated_line_kernel(radius: int, angle: int, pad: int) -> np.ndarray:
    """Horizontal line kernel spun by a bilinear warp (the reference's
    cv.getRotationMatrix2D + warpAffine recipe, on our warp kernel)."""
    from ....ops.warp import warp_affine_np

    size = 2 * radius + 1 + pad
    center = radius + pad // 2
    kernel = np.zeros((size, size), dtype=np.float32)
    kernel[center, pad // 2:pad // 2 + 2 * radius + 1] = 1.0

    # Counter-clockwise (360 - angle) about the kernel center, unit scale.
    theta = np.radians(360 - (angle % 360))
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    matrix = np.asarray([
        (cos_t, sin_t, (1 - cos_t) * center - sin_t * center),
        (-sin_t, cos_t, sin_t * center + (1 - cos_t) * center),
    ], dtype=np.float32)
    spun = warp_affine_np(kernel[..., None], matrix, (size, size))[..., 0]
    spun = spun.astype(np.float32)
    return spun / spun.sum()


@photometric_op(MotionBlurConfig)
def motion_blur(config: MotionBlurConfig, image: Image, rng) -> Image:
    pad = estimate_gaussian_kernel_size(config.anti_aliasing_sigma) // 2 * 2
    line = _rotated_line_kernel(config.radius, config.angle, pad)
    kernel = _smooth_kernel(line, config.anti_aliasing_sigma)
    return apply_in_rgb(
        image, lambda im: im.replace(mat=blur_ops.filter2d_np(im.mat, kernel))
    )


@attr.define
class GlassBlurConfig(DistortionConfig):
    sigma: float
    delta: int = 1
    loop: int = 5
    rng_state: Optional[Mapping[str, Any]] = None


def build_glass_blur_permutation(
    shape: Tuple[int, int],
    delta: int,
    loop: int,
    rng: RandomGenerator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Iterated grid-strided random pixel swaps; returns gather maps."""
    height, width = shape
    pos_x, pos_y = np.meshgrid(np.arange(width), np.arange(height))
    stride = 2 * delta + 1

    for _ in range(loop):
        offset_y = rng.integers(0, stride)
        center_y = np.arange(offset_y, height - delta, stride).reshape(-1, 1)
        offset_x = rng.integers(0, stride)
        center_x = np.arange(offset_x, width - delta, stride).reshape(1, -1)

        jitter_shape = (center_y.shape[0], center_x.shape[1])
        jitter_y = rng.integers(-delta, delta + 1, jitter_shape)
        jitter_x = rng.integers(-delta, delta + 1, jitter_shape)

        swap_y = np.clip(pos_y[center_y, center_x] + jitter_y, 0, height - 1)
        swap_x = np.clip(pos_x[center_y, center_x] + jitter_x, 0, width - 1)

        pos_y[center_y, center_x], pos_y[swap_y, swap_x] = \
            pos_y[swap_y, swap_x], pos_y[center_y, center_x]
        pos_x[center_y, center_x], pos_x[swap_y, swap_x] = \
            pos_x[swap_y, swap_x], pos_x[center_y, center_x]

    return pos_y, pos_x


@photometric_op(GlassBlurConfig)
def glass_blur(config: GlassBlurConfig, image: Image, rng) -> Image:
    assert rng is not None

    def run(im: Image) -> Image:
        ksize = estimate_gaussian_kernel_size(config.sigma)
        mat = blur_ops.gaussian_blur_np(im.mat, config.sigma, ksize)
        pos_y, pos_x = build_glass_blur_permutation(
            im.shape, config.delta, config.loop, rng
        )
        return im.replace(mat=mat[pos_y, pos_x])

    return apply_in_rgb(image, run)


@attr.define
class ZoomInBlurConfig(DistortionConfig):
    ratio: float = 0.1
    step: float = 0.01
    alpha: float = 0.5


@photometric_op(ZoomInBlurConfig)
def zoom_in_blur(config: ZoomInBlurConfig, image: Image, rng) -> Image:

    def run(im: Image) -> Image:
        acc = im.mat.astype(np.float64)
        count = 1
        zooms = np.arange(1 + config.step, 1 + config.ratio + config.step, config.step)
        for zoom in zooms:
            zh = round(im.height * zoom)
            zw = round(im.width * zoom)
            grown = resize_np(im.mat, (zh, zw), Interpolation.CUBIC)
            y0 = (zh - im.height) // 2
            x0 = (zw - im.width) // 2
            acc += grown[y0:y0 + im.height, x0:x0 + im.width]
            count += 1
        mixed = (1 - config.alpha) * im.mat + config.alpha * np.round(acc / count)
        return im.replace(mat=clip_u8(mixed))

    return apply_in_rgb(image, run)
