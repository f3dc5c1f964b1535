"""Batched affine warp as per-line shifts + a 3-tap blend (two-shear form).

Port of vkit_tpu/ops/warp_mxu.py's device half: ``apply_line_resample``,
``apply_affine_warp`` and ``apply_affine_warp_quad``.  The host planners
(``plan_line_resample``, ``plan_affine_warp``, ``quadrant_reduce_mats``)
are the reference's own, imported from vkit_tpu; their numpy plans become
tensors through vkit_tpu_torch.convert.

The integer part of each line's offset is a per-row shift (the row-shift
kernels of ops/kernels.py); the slope part is a 3-tap gather and hat blend.
The reference built that blend as a one-hot matmul for the TPU's matrix
unit; a gather computes the same values without the (N, M, 3J) operand.
"""
import numpy as np
import torch
import torch.nn.functional as F

from vkit_tpu.ops.warp_mxu import (  # noqa: F401 - host planners, re-exported
    AffineWarpPlan,
    AffineWarpStatics,
    LineResamplePlan,
    LineResampleStatics,
    plan_affine_warp,
    plan_line_resample,
    quadrant_reduce_mats,
)

from .kernels import ROLL_WINDOW, WINDOW, row_shift, row_shift_window_slab
from .warp import to_image_dtype


def apply_line_resample(x_slab, plan: LineResamplePlan,
                        statics: LineResampleStatics,
                        border_value: float = 0.0):
    """Resample (N, L, C, M_in) float32 along the last axis ->
    (N, L, C, out_len).  ``plan`` holds tensors on ``x_slab``'s device
    (convert.line_resample_plan)."""
    n, l, c, m_in = x_slab.shape
    x_slab = x_slab.contiguous()

    # Same static route as the reference: the borderless 2048-lane window
    # kernel when the shifted span fits it, else the padded roll kernel.
    rel_min = -statics.pad_lo
    rel_max = statics.m_padded - ROLL_WINDOW - statics.pad_lo
    window_ok = (
        m_in + statics.m_shift <= WINDOW
        and rel_min >= -(WINDOW - m_in - statics.m_shift)
        and rel_max <= WINDOW - statics.m_shift
    )
    if window_ok:
        shifted = row_shift_window_slab(
            x_slab, (plan.starts - statics.pad_lo).to(torch.int32).contiguous(),
            statics.m_shift, border_value=border_value,
        )                                                 # (N, L, C, m_shift)
    else:
        starts = plan.starts[:, :, None].expand(n, l, c).reshape(n, l * c)
        x_p = F.pad(
            x_slab,
            (statics.pad_lo, statics.m_padded - m_in - statics.pad_lo),
            value=border_value,
        )
        shifted = row_shift(
            x_p.reshape(n, l * c, statics.m_padded),
            starts.to(torch.int32).contiguous(), statics.m_shift,
        ).reshape(n, l, c, statics.m_shift)

    # 3-tap gather at i0 + {0, 1, 2} and the hat blend (the reference's
    # one-hot einsum + weighted sum, same summation order).
    jn = statics.out_len
    i0 = plan.i0.to(torch.int64)[:, None, None, :].expand(n, l, c, jn)
    a0 = torch.gather(shifted, 3, i0)
    a1 = torch.gather(shifted[..., 1:], 3, i0)
    a2 = torch.gather(shifted[..., 2:], 3, i0)

    u = plan.frac_j[:, None, :] + plan.phi[:, :, None]     # (N, L, J)
    w0 = torch.clamp(1.0 - u, min=0.0)
    w2 = torch.clamp(u - 1.0, min=0.0)
    w1 = 1.0 - w0 - w2
    w0, w1, w2 = (w[:, :, None, :] for w in (w0, w1, w2))
    return a0 * w0 + a1 * w1 + a2 * w2                      # (N, L, C, J)


def apply_affine_warp(images, plan: AffineWarpPlan, statics: AffineWarpStatics,
                      border_value: float = 0.0):
    """Warp (N, H, W, C) float32/uint8 by the planned decomposition."""
    had_c = images.dim() == 4
    if not had_c:
        images = images[..., None]
    orig_dtype = images.dtype
    x = images.to(torch.float32)

    # Pass V: lines = input columns; resample along rows (slab layout).
    x_v = x.permute(0, 2, 3, 1)                            # (N, W_in, C, H_in)
    tmp = apply_line_resample(x_v, plan.pass_v, statics.statics_v,
                              border_value)
    # (N, W_in, C, H_out) -> pass H layout: lines = output rows.
    x_h = tmp.permute(0, 3, 2, 1)                          # (N, H_out, C, W_in)
    out = apply_line_resample(x_h, plan.pass_h, statics.statics_h,
                              border_value)
    out = out.permute(0, 1, 3, 2)                          # (N, H_out, W_out, C)
    out = to_image_dtype(out, orig_dtype)
    return out if had_c else out[..., 0]


def rot90_samples(images, quadrants):
    """Per-sample ``np.rot90(image, k, axes=(1, 2))`` with k from
    ``quadrants`` (host (N,) ints).  k in {1, 3} needs a square image."""
    quadrants = np.asarray(quadrants)
    out = images
    for k in (1, 2, 3):
        sel = np.flatnonzero(quadrants == k)
        if len(sel) == 0:
            continue
        if out is images:
            out = images.clone()
        idx = torch.as_tensor(sel, device=images.device)
        out[idx] = torch.rot90(images[idx], k, (1, 2))
    return out


def apply_affine_warp_quad(images, quadrants, plan: AffineWarpPlan,
                           statics: AffineWarpStatics,
                           border_value: float = 0.0):
    """Per-sample rot90 by ``quadrants`` (N,) host ints, then the two-shear
    warp.  Like the reference, a non-square source honours only quadrant 2
    (the reducer picks 1 and 3 for square sources only)."""
    had_c = images.dim() == 4
    if not had_c:
        images = images[..., None]
    quadrants = np.asarray(quadrants)
    if images.shape[1] != images.shape[2]:
        quadrants = np.where(quadrants == 2, 2, 0)
    images = rot90_samples(images, quadrants)
    out = apply_affine_warp(images, plan, statics, border_value=border_value)
    return out if had_c else out[..., 0]
