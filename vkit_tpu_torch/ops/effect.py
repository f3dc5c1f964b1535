"""Effect kernels: the diamond-square fog field.

Port of vkit_tpu/ops/effect.py ``diamond_square_mask``.  The catalog's
pixelation (mechanism/batched.py) resamples each sample by its own composed
down / nearest-up matrix instead of the reference's single-image
``pixelation``.  The JPEG quant tables and ``_quality_scaled_table`` are the reference's host
code; the JPEG roundtrip itself is ops/jpeg_exact.py.

``diamond_square_mask`` is batched: one field per roughness, every octave's
noise drawn for the whole batch at once (fog runs it at 1024 x 1024 for a
640-px page).
"""
import math

import numpy as np
import torch

from .resize import Interpolation, resize_weights

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
