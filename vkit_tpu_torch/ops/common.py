"""Shared device-side helpers (port of vkit_tpu/ops/common.py).

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
import torch


def to_f32(image):
    return image.to(torch.float32)


def round_u8(image):
    """Round + saturate to uint8 (cv2-style)."""
    return torch.clamp(torch.round(image), 0, 255).to(torch.uint8)


def expand_chw(image):
    """Ensure a trailing channel dim; returns (image3d, had_channels)."""
    if image.dim() == 2:
        return image[..., None], False
    return image, True


def scalar(value, like):
    """``value`` as a 0-dim tensor on ``like``'s device and dtype.  Dividing
    by it is a true division on CUDA too, where a Python-number divisor is
    turned into a multiplication by its reciprocal."""
    return torch.full((), value, dtype=like.dtype, device=like.device)
