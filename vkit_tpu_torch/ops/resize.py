"""Device-side resize as two weight matmuls (from vkit_tpu/ops/resize.py).

The weight matrices are the reference's own, built on the host by the
numpy ``build_resize_weights`` (ops/resize_taps.py).  The fog field
(ops/effect.py) upsamples its octaves with them; ``resize`` closes the
one-program chain (parallel/batch.py).
"""
import functools
from typing import Tuple

import numpy as np
import torch

from .common import expand_chw, round_u8
from .resize_taps import Interpolation, build_resize_weights

__all__ = ['Interpolation', 'resize', 'resize_weights']


@functools.lru_cache(maxsize=4096)
def _weights(n_src: int, n_dst: int, interpolation: Interpolation):
    return build_resize_weights(n_src, n_dst, interpolation)


def resize_weights(n_src: int, n_dst: int, interpolation: Interpolation,
                   device) -> torch.Tensor:
    """(n_dst, n_src) float32 resize weights on ``device``."""
    return torch.from_numpy(
        np.array(_weights(n_src, n_dst, interpolation))
    ).to(device)



def resize(image, resized_shape: Tuple[int, int],
           interpolation: Interpolation = Interpolation.LINEAR):
    """Resize (H, W[, C]) or (N, H, W, C) to ``resized_shape``; dtype kept."""
    batched = image.dim() == 4
    if not batched:
        image3, had_c = expand_chw(image)
        image4 = image3[None]
    else:
        image4 = image
        had_c = True

    height, width = image4.shape[1:3]
    dst_h, dst_w = resized_shape
    w_rows = resize_weights(height, dst_h, interpolation, image.device)
    w_cols = resize_weights(width, dst_w, interpolation, image.device)

    x = image4.to(torch.float32)
    # (N, H, W, C) -> rows: contract H, then columns: contract W.
    x = torch.einsum('nhwc,vh->nvwc', x, w_rows)
    x = torch.einsum('nvwc,uw->nvuc', x, w_cols)

    x = round_u8(x) if image.dtype == torch.uint8 else x.to(image.dtype)
    if not batched:
        x = x[0]
        if not had_c:
            x = x[..., 0]
    return x
