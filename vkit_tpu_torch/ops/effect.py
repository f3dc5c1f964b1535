"""Effect kernels: JPEG-quality simulation (block DCT), pixelation,
the diamond-square fog field.

Port of vkit_tpu/ops/effect.py.  ``jpeg_quality`` simulates a JPEG
roundtrip on the device as the reference does: RGB -> YCbCr, 4:2:0 chroma
(2 x 2 mean, bilinear up through ops/resize.py), the 8 x 8 DCT as two
float32 einsums, quantization with libjpeg's quality-scaled tables, and
back.  A float32 sum taken in another order can move ``coeff / q`` across
a rounding boundary, so a few blocks may differ from the reference (the
tests state the share).  On CUDA the einsums need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``).  The catalog's
``jpeg_quality`` is the bit-exact roundtrip of ops/jpeg_exact.py, and its
pixelation (mechanism/batched.py) resamples each sample by its own
composed down / nearest-up matrix; ``pixelation`` here is the reference's
single-image form.  The quant tables, ``_quality_scaled_table``,
``_dct_matrix`` and the host twin ``jpeg_quality_np`` are the reference's
own code.

``diamond_square_mask`` is batched: one field per roughness, every octave's
noise drawn for the whole batch at once (fog runs it at 1024 x 1024 for a
640-px page).
"""
import functools
import math

import numpy as np
import torch

from .common import round_u8, to_f32
from .resize import Interpolation, resize, resize_weights

# libjpeg base quantization tables (Annex K of the JPEG standard).
_LUMA_QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)

_CHROMA_QTABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float64)


def _quality_scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    quality = int(np.clip(quality, 1, 100))
    if quality < 50:
        scale = 5000 // quality    # INTEGER division (jcparam.c)
    else:
        scale = 200 - quality * 2
    table = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(table, 1, 255)


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix."""
    mat = np.zeros((8, 8))
    for k in range(8):
        for n in range(8):
            mat[k, n] = math.cos(math.pi * k * (2 * n + 1) / 16)
    mat[0] *= 1 / math.sqrt(2)
    return (mat * 0.5).astype(np.float32)


def _quantize_channel(channel, qtable):
    """8x8 DCT -> quantize -> dequantize -> IDCT of an (H, W) channel, H
    and W multiples of 8, viewed as (H/8, 8, W/8, 8): each 2-D DCT is two
    float32 contractions over the in-block axes."""
    height, width = channel.shape
    dct = torch.from_numpy(_dct_matrix()).to(channel.device)
    y = (channel - 128.0).reshape(height // 8, 8, width // 8, 8)
    coeffs = torch.einsum('ij,ajbk->aibk', dct, y)
    coeffs = torch.einsum('aibk,lk->aibl', coeffs, dct)
    q = torch.as_tensor(qtable, dtype=torch.float32).to(
        channel.device)[None, :, None, :]
    coeffs = torch.round(coeffs / q) * q
    restored = torch.einsum('ji,ajbk->aibk', dct, coeffs)
    restored = torch.einsum('aibk,kl->aibl', restored, dct)
    return restored.reshape(height, width) + 128.0


def _pad_to_multiple(x, mult: int):
    """Edge-pad the first two dims of ``x`` up to multiples of ``mult``."""
    height, width = x.shape[:2]
    rows = torch.arange(height + (-height) % mult, device=x.device)
    cols = torch.arange(width + (-width) % mult, device=x.device)
    x = x.index_select(0, rows.clamp(max=height - 1))
    return x.index_select(1, cols.clamp(max=width - 1)), height, width


def jpeg_quality(image, quality: int):
    """Simulate a JPEG encode/decode roundtrip at the given quality.

    ``image``: uint8 RGB (H, W, 3) or grayscale (H, W) tensor, on its
    device.
    """
    luma_q = _quality_scaled_table(_LUMA_QTABLE, quality)
    chroma_q = _quality_scaled_table(_CHROMA_QTABLE, quality)

    if image.dim() == 2:
        x, height, width = _pad_to_multiple(to_f32(image), 8)
        y = _quantize_channel(x, luma_q)
        return round_u8(y[:height, :width])

    rgb = to_f32(image)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    y_p, height, width = _pad_to_multiple(y, 16)
    cb_p, _, _ = _pad_to_multiple(cb, 16)
    cr_p, _, _ = _pad_to_multiple(cr, 16)

    y_q = _quantize_channel(y_p, luma_q)

    # 4:2:0 chroma subsampling: 2x2 average, quantize, bilinear upsample.
    def chroma_roundtrip(c):
        ph, pw = c.shape
        sub = c.reshape(ph // 2, 2, pw // 2, 2).mean(dim=(1, 3))
        sub_q = _quantize_channel(sub, chroma_q)
        return resize(sub_q, (ph, pw), Interpolation.LINEAR)

    cb_q = chroma_roundtrip(cb_p)
    cr_q = chroma_roundtrip(cr_p)

    y_q = y_q[:height, :width]
    cb_q = cb_q[:height, :width] - 128.0
    cr_q = cr_q[:height, :width] - 128.0

    r2 = y_q + 1.402 * cr_q
    g2 = y_q - 0.344136 * cb_q - 0.714136 * cr_q
    b2 = y_q + 1.772 * cb_q
    return round_u8(torch.stack([r2, g2, b2], dim=-1))


def jpeg_quality_np(image: np.ndarray, quality: int) -> np.ndarray:
    """Numpy twin of :func:`jpeg_quality` for the host per-element path
    (dynamic page shapes would force an XLA compile per shape)."""
    from .resize_taps import resize_np

    luma_q = _quality_scaled_table(_LUMA_QTABLE, quality)
    chroma_q = _quality_scaled_table(_CHROMA_QTABLE, quality)
    dct = _dct_matrix().astype(np.float64)

    def pad_to_multiple(x, mult):
        height, width = x.shape[:2]
        pad_h = (-height) % mult
        pad_w = (-width) % mult
        if pad_h or pad_w:
            x = np.pad(x, ((0, pad_h), (0, pad_w)), mode='edge')
        return x, height, width

    def quantize(channel, qtable):
        height, width = channel.shape
        blocks = (
            (channel - 128.0)
            .reshape(height // 8, 8, width // 8, 8)
            .transpose(0, 2, 1, 3)
        )
        coeffs = np.einsum('ij,hwjk,lk->hwil', dct, blocks, dct)
        coeffs = np.round(coeffs / qtable) * qtable
        restored = np.einsum('ji,hwjk,kl->hwil', dct, coeffs, dct)
        return (
            restored.transpose(0, 2, 1, 3).reshape(height, width) + 128.0
        )

    if image.ndim == 2:
        x, height, width = pad_to_multiple(image.astype(np.float64), 8)
        y = quantize(x, luma_q)[:height, :width]
        return np.clip(np.round(y), 0, 255).astype(np.uint8)

    rgb = image.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    y_p, height, width = pad_to_multiple(y, 16)
    cb_p, _, _ = pad_to_multiple(cb, 16)
    cr_p, _, _ = pad_to_multiple(cr, 16)

    y_q = quantize(y_p, luma_q)

    def chroma_roundtrip(c):
        ph, pw = c.shape
        sub = c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
        sub_q = quantize(sub, chroma_q)
        return resize_np(
            sub_q.astype(np.float32), (ph, pw), Interpolation.LINEAR
        )

    cb_q = chroma_roundtrip(cb_p)[:height, :width] - 128.0
    cr_q = chroma_roundtrip(cr_p)[:height, :width] - 128.0
    y_q = y_q[:height, :width]

    r2 = y_q + 1.402 * cr_q
    g2 = y_q - 0.344136 * cb_q - 0.714136 * cr_q
    b2 = y_q + 1.772 * cb_q
    out = np.stack([r2, g2, b2], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def pixelation(image, resized_shape):
    """Down then nearest-up (vkit effect.py:56-86)."""
    height, width = image.shape[:2]
    down = resize(image, resized_shape, Interpolation.LINEAR)
    return resize(down, (height, width), Interpolation.NEAREST)


def diamond_square_mask(generator, size: int, roughnesses):
    """Plasma-fractal heightfields in [0, 1], (N, size, size), one per
    entry of ``roughnesses`` (N,): each octave adds bilinearly upsampled
    uniform noise with geometrically decaying amplitude."""
    rough = torch.as_tensor(roughnesses, dtype=torch.float32,
                            device=generator.device).reshape(-1)
    n = rough.shape[0]
    num_octaves = max(int(math.ceil(math.log2(max(size, 2)))), 1)
    acc = torch.zeros((n, size, size), dtype=torch.float32,
                      device=rough.device)
    amp = torch.ones_like(rough)
    total = torch.zeros_like(rough)
    for octave in range(num_octaves):
        grid = 2 ** (octave + 1)
        noise = torch.rand((n, grid, grid), generator=generator,
                           device=rough.device)
        w = resize_weights(grid, size, Interpolation.LINEAR, rough.device)
        up = torch.matmul(torch.matmul(w, noise), w.T)
        acc.add_(up * amp[:, None, None])
        total = total + amp
        amp = amp * rough
    acc = acc / total[:, None, None]
    lo = acc.amin(dim=(1, 2), keepdim=True)
    hi = acc.amax(dim=(1, 2), keepdim=True)
    return (acc - lo) / torch.clamp(hi - lo, min=1e-6)
