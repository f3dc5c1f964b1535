"""Coarse-node banded two-pass warp: the general remap of the geometric stage.

Port of vkit_tpu/ops/warp_banded.py's device half: ``_banded_pass_body``,
``_unflip_crop_body``, ``banded_warp_body`` and ``apply_banded_warp``.
Planning (``plan_banded_warp``, ``slice_banded_plan``, the tap ladder and
``_BASE_MAX``) is the reference's own host code, imported from vkit_tpu, so
both packages route every sample the same way.  Plans become tensors
through vkit_tpu_torch.convert.banded_warp_plan.

Each pass upsamples the node positions to a full (N, L, JP) position field
with two float32 matrix products (TF32 stays off: the port never enables
``torch.backends.cuda.matmul.allow_tf32``, and float32 products on the card
then run in full precision), then resamples every line with the banded
kernel (ops/kernels.py banded_line_resample).
"""
from typing import Tuple

import torch

from vkit_tpu.ops.warp_banded import (  # noqa: F401 - host planners, re-exported
    BandedPassPlan,
    BandedWarpPlan,
    plan_banded_warp,
    slice_banded_plan,
)

from .kernels import banded_line_resample


def _banded_pass_body(x, plan: BandedPassPlan, taps: int,
                      border_value: float, pre=None, post=None):
    if pre is not None:
        x = x.permute(pre)
    # pos[n, l, j] = sum_{r, q} w_l[l, r] nodes[n, r, q] w_j[j, q].
    pos = torch.matmul(torch.matmul(plan.w_l, plan.nodes), plan.w_j.T)
    out = banded_line_resample(
        x.contiguous(), plan.base, pos.contiguous(), taps,
        border_value=border_value,
    )
    if post is not None:
        out = out.permute(post)
    return out


def _flip_mask(flags, device):
    return torch.as_tensor(flags, dtype=torch.bool,
                           device=device)[:, None, None, None]


def _unflip_crop_body(out, flip_v, flip_h, h_out: int, w_out: int):
    # Flipped samples carry their content in [0, h_out) of the FLIPPED
    # padded axis; reversing the padded axis puts it at [jp - h_out, jp),
    # the roll brings it back to the front.
    rev = torch.roll(out.flip(1), h_out - out.shape[1], dims=1)
    out = torch.where(_flip_mask(flip_v, out.device), rev, out)[:, :h_out]
    rev = torch.roll(out.flip(2), w_out - out.shape[2], dims=2)
    out = torch.where(_flip_mask(flip_h, out.device), rev, out)[:, :, :w_out]
    return out


def banded_warp_body(images, plan: BandedWarpPlan, dst_shape: Tuple[int, int],
                     taps: int, flips=None, border_value: float = 0.0):
    """Both banded passes + the unflip crop: (N, H, W, C) ->
    (N, H', W', C) float32.  ``plan`` holds tensors on ``images``' device
    (convert.banded_warp_plan); ``flips``: per-sample (flip_rows,
    flip_cols) host bool arrays from the planner."""
    h_out, w_out = tuple(dst_shape)
    had_c = images.dim() == 4
    if not had_c:
        images = images[..., None]
    x = images.to(torch.float32)

    tmp = _banded_pass_body(
        x, plan.pass_v, taps, border_value,
        pre=(0, 2, 3, 1),                  # (N, W_in, C, H_in): j = dst rows
    )                                      # (N, W_in, C, JP_v)
    out = _banded_pass_body(
        tmp, plan.pass_h, taps, border_value,
        pre=(0, 3, 2, 1),                  # (N, JP_v, C, W_in): j = dst cols
        post=(0, 1, 3, 2),                 # (N, JP_v, JP_h, C)
    )
    if flips is not None:
        out = _unflip_crop_body(out, flips[0], flips[1], h_out, w_out)
    else:
        out = out[:, :h_out, :w_out]
    if not had_c:
        out = out[..., 0]
    return out


# The reference's ``apply_banded_warp`` jit-compiles ``banded_warp_body``
# as one program; run eagerly, the body is the entry point.
apply_banded_warp = banded_warp_body
