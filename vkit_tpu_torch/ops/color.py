"""Colorspace conversions and histogram equalization on the device.

Port of vkit_tpu/ops/color.py.  The HSV / HSL formulas are the reference's,
operation for operation.  ``equalize_hist_batch`` counts its 256-bin
histograms with ``scatter_add`` and applies the LUT with a gather: the
reference's nibble-decomposed one-hot contractions stood in for a
scatter-add on the TPU.  Every step is integer-exact, so both give the same
planes.  ``equalize_hist`` is the reference's single-plane form over it.
"""
import torch

from .common import round_u8, scalar, to_f32


def rgb_to_gray(image):
    x = to_f32(image)
    y = x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
    return round_u8(y) if image.dtype == torch.uint8 else y


def _hue(mx, r, g, b, diff):
    safe = torch.where(diff == 0, 1.0, diff)
    h = torch.where(
        mx == r,
        60.0 * (g - b) / safe,
        torch.where(mx == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe),
    )
    h = torch.where(diff == 0, 0.0, h)
    return torch.where(h < 0, h + 360.0, h)


def rgb_to_hsv_full(image):
    rgb = to_f32(image)
    r, g, b = rgb.unbind(-1)
    v = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    diff = v - mn
    s = torch.where(v > 0, diff / torch.where(v == 0, 1.0, v) * 255.0, 0.0)
    h = _hue(v, r, g, b, diff)
    out = torch.stack([h * (255.0 / 360.0), s, v], dim=-1)
    return round_u8(out) if image.dtype == torch.uint8 else out


def _sectors(hp, c, x):
    """(r1, g1, b1) of the six hue sectors (``jnp.select`` of the
    reference)."""
    sector = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    z = torch.zeros_like(c)
    table = ((c, x, z, z, x, c), (x, c, c, x, z, z), (z, z, x, c, c, x))
    outs = []
    for choices in table:
        out = z
        for k in range(5, -1, -1):
            out = torch.where(sector == k, choices[k], out)
        outs.append(out)
    return outs


def hsv_full_to_rgb(image):
    h = to_f32(image[..., 0]) * (360.0 / 255.0)
    s = to_f32(image[..., 1])
    s = s / scalar(255.0, s)
    v = to_f32(image[..., 2])

    c = v * s
    hp = h / scalar(60.0, h)
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    r1, g1, b1 = _sectors(hp, c, x)
    out = torch.stack([r1 + m, g1 + m, b1 + m], dim=-1)
    return round_u8(out) if image.dtype == torch.uint8 else out


def rgb_to_hsl_full(image):
    rgb = to_f32(image)
    rgb = rgb / scalar(255.0, rgb)
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    diff = mx - mn
    summ = mx + mn
    lum = summ / scalar(2.0, summ)
    denom = torch.where(lum < 0.5, summ, 2.0 - summ)
    s = torch.where(diff == 0, 0.0,
                    diff / torch.where(denom == 0, 1.0, denom))
    h = _hue(mx, r, g, b, diff)
    out = torch.stack([h * (255.0 / 360.0), s * 255.0, lum * 255.0], dim=-1)
    return round_u8(out) if image.dtype == torch.uint8 else out


def hsl_full_to_rgb(image):
    h = to_f32(image[..., 0]) * (360.0 / 255.0)
    s = to_f32(image[..., 1])
    s = s / scalar(255.0, s)
    lum = to_f32(image[..., 2])
    lum = lum / scalar(255.0, lum)

    c = (1.0 - torch.abs(2.0 * lum - 1.0)) * s
    hp = h / scalar(60.0, h)
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = lum - c / scalar(2.0, c)
    r1, g1, b1 = _sectors(hp, c, x)
    out = torch.stack([r1 + m, g1 + m, b1 + m], dim=-1) * 255.0
    return round_u8(out) if image.dtype == torch.uint8 else out


def equalize_hist_batch(channels):
    """(B, H, W) uint8 -> (B, H, W), cv2.equalizeHist per plane."""
    b, h, w = channels.shape
    hw = h * w
    v = channels.reshape(b, hw).to(torch.int64)
    hist = torch.zeros((b, 256), dtype=torch.float32, device=channels.device)
    hist.scatter_add_(1, v, torch.ones((b, hw), dtype=torch.float32,
                                       device=channels.device))
    cdf = torch.cumsum(hist, dim=-1)
    # First nonzero cdf value.
    cdf_min = torch.where(hist > 0, cdf, float(hw + 1)).amin(dim=-1,
                                                            keepdim=True)
    denom = torch.clamp(hw - cdf_min, min=1.0)
    lut = torch.clamp(torch.round((cdf - cdf_min) / denom * 255.0), 0, 255)
    mapped = torch.gather(lut, 1, v).reshape(b, h, w).to(torch.uint8)
    same = (cdf_min >= hw).reshape(b, 1, 1)  # Single-value plane: identity.
    return torch.where(same, channels, mapped)


def equalize_hist(channel):
    """Per-channel histogram equalization (cv2.equalizeHist semantics)."""
    return equalize_hist_batch(channel[None])[0]
