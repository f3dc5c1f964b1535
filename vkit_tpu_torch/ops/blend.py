"""Device-side masked / alpha blend (port of vkit_tpu/ops/blend.py)."""
from typing import Optional, Union

import torch

from .common import round_u8, to_f32


def blend(
    mat,
    value,
    np_mask: Optional[torch.Tensor] = None,
    alpha: Union[torch.Tensor, float] = 1.0,
    keep_max_value: bool = False,
    keep_min_value: bool = False,
):
    """Functional masked/alpha blend.  ``mat`` (..., H, W[, C]); ``value``
    broadcastable to mat; ``np_mask`` bool (H, W); ``alpha`` scalar or
    (H, W) float in [0, 1]."""
    if keep_max_value and keep_min_value:
        raise ValueError('keep_max_value and keep_min_value exclude each other')
    value = torch.as_tensor(value, dtype=mat.dtype,
                            device=mat.device).broadcast_to(mat.shape)
    if keep_max_value:
        value = torch.maximum(mat, value)
    elif keep_min_value:
        value = torch.minimum(mat, value)

    alpha_arr = torch.as_tensor(alpha, dtype=torch.float32, device=mat.device)
    if alpha_arr.dim() and mat.dim() == alpha_arr.dim() + 1:
        alpha_arr = alpha_arr[..., None]

    blended = (1.0 - alpha_arr) * to_f32(mat) + alpha_arr * to_f32(value)
    if mat.dtype == torch.uint8:
        blended = round_u8(blended)
    else:
        blended = blended.to(mat.dtype)

    if np_mask is not None:
        mask = torch.as_tensor(np_mask, device=mat.device)
        if mat.dim() == mask.dim() + 1:
            mask = mask[..., None]
        blended = torch.where(mask, blended, mat)
    return blended
