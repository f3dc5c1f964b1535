"""Blur kernels: cv2.filter2D semantics (correlate, reflect-101 border).

Port of vkit_tpu/ops/blur.py ``_depthwise_conv2d`` and ``filter2d`` as a
reflect pad and a grouped ``F.conv2d``; the catalog's blurs
(mechanism/batched.py) build their per-sample kernels on the host and call
``filter2d``.  ``jnp.pad(mode='reflect')`` is reflect-101, as torch's
reflect mode is.

On CUDA, ``F.conv2d`` runs in cuDNN, which uses TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; parity with the CPU needs it
off.
"""
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

