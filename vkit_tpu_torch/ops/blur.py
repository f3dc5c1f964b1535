"""Blur kernels: cv2.filter2D semantics (correlate, reflect-101 border).

Port of vkit_tpu/ops/blur.py ``_depthwise_conv2d`` and ``filter2d`` as a
reflect pad and a grouped ``F.conv2d``; the catalog's blurs
(mechanism/batched.py) build their per-sample kernels on the host and call
``filter2d``, and so do the single-image ``gaussian_blur`` and
``box_blur``.  ``jnp.pad(mode='reflect')`` is reflect-101, as torch's
reflect mode is.

On CUDA, ``F.conv2d`` runs in cuDNN, which uses TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; parity with the CPU needs it
off.

The numpy host half (the kernel constructors ``gaussian_kernel1d``,
``disk_kernel``, ``motion_line_kernel`` and the per-image ``filter2d_np``,
``gaussian_blur_np``, ``box_blur_np``) is the reference's own code: the
catalog preps and the per-element blurs call it.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from .common import expand_chw, round_u8


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of the ``n + 2 * pad`` reflect-101 padded
    positions; periodic beyond one reflection, as ``np.pad`` extends it."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _reflect_pad(x, pad_h: int, pad_w: int):
    """Reflect-101 pad of the last two dims of (N, C, H, W)."""
    height, width = x.shape[-2:]
    if pad_h < height and pad_w < width:
        return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode='reflect')
    # torch's reflect mode refuses pads as wide as the image.
    x = x.index_select(2, _reflect_index(height, pad_h, x.device))
    return x.index_select(3, _reflect_index(width, pad_w, x.device))


def _depthwise_conv2d(image4, kernels):
    """(N, H, W, C) correlated with ``kernels`` -> (N, H, W, C) float32.

    ``kernels``: (kh, kw) shared by every sample, or (N, kh, kw), one per
    sample (the reference's ``jax.vmap(filter2d)``); the kernel applies to
    every channel, with a reflect-101 border."""
    kernels = convert.to_tensor(kernels, image4.device, torch.float32)
    kh, kw = kernels.shape[-2:]
    n, height, width, channels = image4.shape
    x = image4.to(torch.float32).permute(0, 3, 1, 2)
    x = _reflect_pad(x, kh // 2, kw // 2)
    if kernels.dim() == 2:
        weight = kernels.expand(channels, 1, kh, kw)
        out = F.conv2d(x, weight, groups=channels)
    else:
        weight = kernels[:, None].expand(n, channels, kh, kw).reshape(
            n * channels, 1, kh, kw)
        out = F.conv2d(x.reshape(1, n * channels, *x.shape[-2:]), weight,
                       groups=n * channels)
        out = out.reshape(n, channels, height, width)
    return out.permute(0, 2, 3, 1)


def filter2d(image, kernel2d):
    """cv2.filter2D equivalent (correlate, reflect-101 border); dtype kept.
    A batched (N, H, W, C) image may take one kernel per sample
    (``kernel2d`` of shape (N, kh, kw))."""
    batched = image.dim() == 4
    if not batched:
        image3, had_c = expand_chw(image)
        image4 = image3[None]
    else:
        image4 = image
        had_c = True

    out = _depthwise_conv2d(image4, kernel2d)

    if image.dtype == torch.uint8:
        out = round_u8(out)
    else:
        out = out.to(image.dtype)
    if not batched:
        out = out[0]
        if not had_c:
            out = out[..., 0]
    return out


def gaussian_blur(image, sigma: float, ksize: int = 0):
    """cv2.GaussianBlur equivalent (separable)."""
    if ksize <= 0:
        # cv2 derives ksize from sigma when ksize==0.
        ksize = int(round(sigma * 3 * 2 + 1)) | 1
    k1 = gaussian_kernel1d(sigma, ksize)
    kernel = np.outer(k1, k1)
    return filter2d(image, kernel)


def box_blur(image, ksize: int):
    kernel = np.full((ksize, ksize), 1.0 / (ksize * ksize), dtype=np.float32)
    return filter2d(image, kernel)


# --------------------------------------------------------------------------
# Host (numpy) half: kernel constructors and per-image twins.
# --------------------------------------------------------------------------


def gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    """Matches cv2.getGaussianKernel (sigma<=0 derives from ksize)."""
    assert ksize % 2 == 1
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    kernel = np.exp(-(xs**2) / (2 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


def disk_kernel(radius: int, alias_blur: float = 0.1) -> np.ndarray:
    """Anti-aliased disk (defocus) kernel, normalized.

    Mirrors the defocus construction at blur.py:79-129 (disk + small gaussian
    anti-alias).
    """
    if radius <= 8:
        length = np.arange(-8, 9)
        ksize = 3
    else:
        length = np.arange(-radius, radius + 1)
        ksize = 5
    xs, ys = np.meshgrid(length, length)
    aliased_disk = np.asarray((xs**2 + ys**2) <= radius**2, dtype=np.float64)
    aliased_disk /= aliased_disk.sum()
    # Gaussian anti-alias pass (host-side separable conv).
    g = gaussian_kernel1d(alias_blur, ksize).astype(np.float64)
    blurred = np.apply_along_axis(lambda row: np.convolve(row, g, mode='same'), 1, aliased_disk)
    blurred = np.apply_along_axis(lambda col: np.convolve(col, g, mode='same'), 0, blurred)
    return (blurred / blurred.sum()).astype(np.float32)


def motion_line_kernel(ksize: int, angle_deg: float) -> np.ndarray:
    """Line kernel of length ksize rotated by angle (degrees, CCW).

    Mirrors motion-blur kernel construction at blur.py:132-192 (horizontal
    line + cv2 rotation), built analytically: each kernel cell weights by its
    coverage of the rotated unit-thickness line segment.
    """
    assert ksize % 2 == 1
    center = (ksize - 1) / 2
    rad = math.radians(angle_deg)
    dx, dy = math.cos(rad), -math.sin(rad)
    ys, xs = np.mgrid[0:ksize, 0:ksize]
    rel_x = xs - center
    rel_y = ys - center
    # Distance from cell center to the infinite line, and projection along it.
    dist_perp = np.abs(rel_x * dy - rel_y * dx)
    proj = rel_x * dx + rel_y * dy
    half_len = ksize / 2.0
    kernel = np.where((dist_perp <= 0.5) & (np.abs(proj) <= half_len), 1.0, 0.0)
    if kernel.sum() == 0:
        kernel[int(center), int(center)] = 1.0
    return (kernel / kernel.sum()).astype(np.float32)


def filter2d_np(image: np.ndarray, kernel2d: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`filter2d` (correlate, reflect-101 border)."""
    from scipy.ndimage import correlate

    kernel2d = np.asarray(kernel2d, dtype=np.float32)
    had_c = image.ndim == 3
    image3 = image if had_c else image[..., None]
    src = image3.astype(np.float32)
    out = np.empty_like(src)
    for ch in range(src.shape[-1]):
        # scipy 'mirror' == cv2 reflect-101.
        out[..., ch] = correlate(src[..., ch], kernel2d, mode='mirror')
    if not had_c:
        out = out[..., 0]
    if image.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)


def gaussian_blur_np(image: np.ndarray, sigma: float, ksize: int = 0) -> np.ndarray:
    """Numpy twin of :func:`gaussian_blur` (separable, cv2 kernel taps)."""
    if ksize <= 0:
        ksize = int(round(sigma * 3 * 2 + 1)) | 1
    k1 = gaussian_kernel1d(sigma, ksize)
    return filter2d_np(image, np.outer(k1, k1))


def box_blur_np(image: np.ndarray, ksize: int) -> np.ndarray:
    kernel = np.full((ksize, ksize), 1.0 / (ksize * ksize), dtype=np.float32)
    return filter2d_np(image, kernel)
