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

import torch

from vkit_tpu.ops.effect import (  # noqa: F401 - host tables, re-exported
    _CHROMA_QTABLE,
    _LUMA_QTABLE,
    _quality_scaled_table,
)

from .resize import Interpolation, resize_weights


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
