"""Bit-exact libjpeg (IJG) roundtrip on the device, in int32.

Port of vkit_tpu/ops/jpeg_exact.py ``jpeg_roundtrip_exact_jnp``, batched
over a leading sample axis with one pair of quant tables per sample:
libjpeg's fixed-point RGB<->YCbCr conversion, the biased h2v2 chroma
downsample, the islow integer FDCT/IDCT, round-half-away quantization and
the triangular "fancy" chroma upsample.  The DCT passes are the
reference's backend-generic ``_fdct_islow_xp`` / ``_idct_islow_xp``, run
here on torch int32 tensors.  Every shift is arithmetic on int32 in both
frameworks, and the one division divides non-negative values, so libjpeg's
rounding of negative values carries over unchanged.
"""
import types

import torch

from vkit_tpu.ops.jpeg_exact import (
    _ONE_HALF,
    _SCALEBITS,
    _fdct_islow_xp,
    _fix,
    _idct_islow_xp,
)

# The array namespace the reference's DCT passes call (``xp.stack``).
_XP = types.SimpleNamespace(
    stack=lambda arrays, axis: torch.stack(arrays, dim=axis)
)


def _pad_edge(x, pad_h: int, pad_w: int):
    """Edge-replicate pad of dims 1 and 2 of (N, H, W, ...) at the bottom
    and the right."""
    if pad_h:
        rows = torch.arange(x.shape[1] + pad_h, device=x.device)
        x = x.index_select(1, rows.clamp(max=x.shape[1] - 1))
    if pad_w:
        cols = torch.arange(x.shape[2] + pad_w, device=x.device)
        x = x.index_select(2, cols.clamp(max=x.shape[2] - 1))
    return x


def _pad_to(c, mult_h: int, mult_w: int):
    return _pad_edge(c, (-c.shape[1]) % mult_h, (-c.shape[2]) % mult_w)


def _down(c):
    """h2v2 downsample: 2x2 sums with libjpeg's alternating 1 / 2 bias."""
    n, hh, ww = c.shape
    v = c.reshape(n, hh // 2, 2, ww // 2, 2).sum(dim=(2, 4),
                                                 dtype=torch.int32)
    bias = torch.where(torch.arange(ww // 2, device=c.device) % 2 == 0, 1, 2)
    return (v + bias.to(torch.int32)) >> 2


def _roundtrip(c, q):
    """Encode + decode planes (N, hh, ww), multiples of 8, with per-sample
    tables ``q`` (N, 8, 8) int32."""
    n, hh, ww = c.shape
    nb = (hh // 8) * (ww // 8)
    blocks = (c - 128).reshape(n, hh // 8, 8, ww // 8, 8).permute(
        0, 1, 3, 2, 4).reshape(n * nb, 8, 8)
    coeffs = _fdct_islow_xp(blocks, _XP)
    q = q[:, None].expand(n, nb, 8, 8).reshape(n * nb, 8, 8)
    qdiv = q << 3
    mag = (torch.abs(coeffs) + (qdiv >> 1)) // qdiv
    quant = torch.where(coeffs < 0, -mag, mag)
    spatial = _idct_islow_xp(quant * q, _XP) + 128
    spatial = torch.clamp(spatial, 0, 255)
    return spatial.reshape(n, hh // 8, ww // 8, 8, 8).permute(
        0, 1, 3, 2, 4).reshape(n, hh, ww)


def _fancy_up(sub):
    """jdsample.c h2v2_fancy_upsample of (N, sh, sw) planes."""
    n, sh, sw = sub.shape
    up = torch.cat([sub[:, :1], sub[:, :-1]], dim=1)
    dn = torch.cat([sub[:, 1:], sub[:, -1:]], dim=1)
    near = sub * 3
    rows = torch.stack([near + up, near + dn], dim=2).reshape(n, sh * 2, sw)
    left = torch.cat([rows[:, :, :1], rows[:, :, :-1]], dim=2)
    right = torch.cat([rows[:, :, 1:], rows[:, :, -1:]], dim=2)
    even = (rows * 3 + left + 8) >> 4
    odd = (rows * 3 + right + 7) >> 4
    out = torch.stack([even, odd], dim=3).reshape(n, sh * 2, sw * 2)
    out[:, :, 0] = (rows[:, :, 0] * 4 + 8) >> 4
    out[:, :, -1] = (rows[:, :, -1] * 4 + 7) >> 4
    return out


def jpeg_roundtrip_exact(images, luma_q, chroma_q):
    """Bit-exact libjpeg roundtrip of (N, H, W, 3) uint8 RGB images with
    per-sample (N, 8, 8) int32 quant tables; returns (N, H, W, 3) uint8.

    Pads mirror the reference's asymmetric edge expansion: columns expand
    at the source level before downsampling, bottom rows pad at the
    subsampled plane's block boundary, and the decoder's fancy upsampler
    walks only the real downsampled extent."""
    n, h, w = images.shape[:3]
    luma_q = luma_q.to(device=images.device, dtype=torch.int32)
    chroma_q = chroma_q.to(device=images.device, dtype=torch.int32)
    rgb = _pad_edge(images.to(torch.int32), h % 2, w % 2)
    r, g, b = rgb.unbind(-1)

    cbcr_offset = 128 << _SCALEBITS
    y = (
        _fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + _ONE_HALF
    ) >> _SCALEBITS
    cb = (
        -_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
        + cbcr_offset + _ONE_HALF - 1
    ) >> _SCALEBITS
    cr = (
        _fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
        + cbcr_offset + _ONE_HALF - 1
    ) >> _SCALEBITS

    y_rt = _roundtrip(_pad_to(y, 8, 8), luma_q)[:, :h, :w]
    ch, cw = -(-h // 2), -(-w // 2)

    def chroma(c):
        sub = _roundtrip(_pad_to(_down(_pad_to(c, 1, 16)), 8, 1), chroma_q)
        return _fancy_up(sub[:, :ch, :cw])[:, :h, :w] - 128

    cbd = chroma(cb)
    crd = chroma(cr)
    r2 = y_rt + ((_fix(1.40200) * crd + _ONE_HALF) >> _SCALEBITS)
    b2 = y_rt + ((_fix(1.77200) * cbd + _ONE_HALF) >> _SCALEBITS)
    g2 = y_rt + (
        (-_fix(0.34414) * cbd - _fix(0.71414) * crd + _ONE_HALF)
        >> _SCALEBITS
    )
    out = torch.stack([r2, g2, b2], dim=-1)
    return torch.clamp(out, 0, 255).to(torch.uint8)
