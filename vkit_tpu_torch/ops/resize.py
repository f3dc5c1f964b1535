"""Device-side resize weights (from vkit_tpu/ops/resize.py).

The weight matrices are the reference's own, built on the host by the
numpy ``build_resize_weights`` (ops/resize_taps.py); the fog field
(ops/effect.py) upsamples its octaves with them.
"""
import functools

import numpy as np
import torch

from .resize_taps import Interpolation, build_resize_weights

__all__ = ['Interpolation', 'resize_weights']


@functools.lru_cache(maxsize=4096)
def _weights(n_src: int, n_dst: int, interpolation: Interpolation):
    return build_resize_weights(n_src, n_dst, interpolation)


def resize_weights(n_src: int, n_dst: int, interpolation: Interpolation,
                   device) -> torch.Tensor:
    """(n_dst, n_src) float32 resize weights on ``device``."""
    return torch.from_numpy(
        np.array(_weights(n_src, n_dst, interpolation))
    ).to(device)

