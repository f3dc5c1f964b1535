"""Batched device synthesis: the distortion pipeline as one function.

Port of vkit_tpu/parallel/batch.py.  Per-image parameters are sampled on
the host (numpy, in the reference's order, so both packages draw alike
from one seed) and the whole batch runs through one chain on its device:
geometric warp (the two-shear shifts + taps of ops/warp_mxu.py, on the
row-shift kernels), contrast / brightness / noise, the bit-exact JPEG
roundtrip (ops/jpeg_exact.py) with per-sample quant tables, and the final
resize (two weight matmuls).  Static shapes, no per-sample Python.  The
reference jits the chain into one program; here it is a plain function on
tensors.
"""
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from numpy.random import Generator as RandomGenerator

from .. import convert
from ..ops.common import round_u8, to_f32
from ..ops.effect import _CHROMA_QTABLE, _LUMA_QTABLE, _quality_scaled_table
from ..ops.jpeg_exact import jpeg_roundtrip_exact_torch
from ..ops.resize import Interpolation, resize
from ..ops.warp_mxu import (
    AffineWarpPlan,
    AffineWarpStatics,
    apply_affine_warp,
    plan_affine_warp,
)


class SynthesisParams(NamedTuple):
    """Struct-of-arrays, one row per sample.  ``sample_synthesis_params``
    fills it with numpy arrays; ``convert.synthesis_params`` moves it to a
    device."""
    # Host-planned two-shear warp (ops/warp_mxu.py).
    warp_plan: AffineWarpPlan
    # Forward 3x3 mats kept for label co-transform (transform_label_points).
    trans_mats: np.ndarray      # (N, 3, 3) f32
    contrasts: np.ndarray       # (N,) f32
    brightnesses: np.ndarray    # (N,) f32
    noise_stds: np.ndarray      # (N,) f32
    luma_qtables: np.ndarray    # (N, 8, 8) int32
    chroma_qtables: np.ndarray  # (N, 8, 8) int32
    jpeg_enables: np.ndarray    # (N,) f32 in {0, 1}


def sample_synthesis_params(
    rng: RandomGenerator,
    batch_size: int,
    height: int,
    width: int,
    level: int = 5,
) -> Tuple[SynthesisParams, AffineWarpStatics]:
    """Host-side parameter sampling (numpy rng, like the policy layer).

    Ranges follow the distortion_policy defaults at the given level
    (mechanism/distortion_policy/photometric/color.py,
    geometric/affine.py): rotation up to ~30 deg, shear up to ~15 deg,
    scale 0.8-1.2, brightness +-50, contrast 0.6-1.4, noise std up to 20,
    JPEG quality 95 down to 30.
    """
    ratio = level / 10.0
    n = batch_size
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0

    angles = rng.uniform(-30.0 * ratio, 30.0 * ratio, size=n)
    shears = rng.uniform(-15.0 * ratio, 15.0 * ratio, size=n)
    scales = rng.uniform(1.0 - 0.2 * ratio, 1.0 + 0.2 * ratio, size=n)

    mats = np.zeros((n, 3, 3), dtype=np.float32)
    for idx in range(n):
        rad = math.radians(angles[idx])
        sh = math.tan(math.radians(shears[idx]))
        sc = scales[idx]
        cos_v, sin_v = math.cos(rad) * sc, math.sin(rad) * sc
        # rotate(angle) . shear_x(sh), about the image center.
        rot = np.array([[cos_v, -sin_v], [sin_v, cos_v]])
        shear = np.array([[1.0, sh], [0.0, 1.0]])
        lin = rot @ shear
        mats[idx, :2, :2] = lin
        mats[idx, 0, 2] = cx - lin[0, 0] * cx - lin[0, 1] * cy
        mats[idx, 1, 2] = cy - lin[1, 0] * cx - lin[1, 1] * cy
        mats[idx, 2, 2] = 1.0

    contrasts = rng.uniform(1.0 - 0.4 * ratio, 1.0 + 0.4 * ratio, size=n)
    brightnesses = rng.uniform(-50.0 * ratio, 50.0 * ratio, size=n)
    noise_stds = rng.uniform(0.0, 20.0 * ratio, size=n)

    qualities = rng.integers(max(30, 95 - round(65 * ratio)), 96, size=n)
    luma = np.stack([
        _quality_scaled_table(_LUMA_QTABLE, q) for q in qualities
    ]).astype(np.int32)
    chroma = np.stack([
        _quality_scaled_table(_CHROMA_QTABLE, q) for q in qualities
    ]).astype(np.int32)
    jpeg_enables = (rng.random(n) < 0.7).astype(np.float32)

    warp_plan, warp_statics = plan_affine_warp(mats, (height, width))

    return SynthesisParams(
        warp_plan=warp_plan,
        trans_mats=mats,
        contrasts=contrasts.astype(np.float32),
        brightnesses=brightnesses.astype(np.float32),
        noise_stds=noise_stds.astype(np.float32),
        luma_qtables=luma,
        chroma_qtables=chroma,
        jpeg_enables=jpeg_enables,
    ), warp_statics


def synthesize_batch(
    images,
    params: SynthesisParams,
    generator: torch.Generator,
    warp_statics: AffineWarpStatics,
    out_shape: Optional[Tuple[int, int]] = None,
):
    """The full batched distortion chain: warp + photometric + JPEG + resize.

    ``images``: (N, H, W, 3) uint8 tensor; the chain runs on its device.
    ``params``: on the host or already moved (convert.synthesis_params).
    ``generator``: a torch.Generator on the images' device; the gaussian
    noise draws from it, so it matches the reference in distribution only.
    Returns (N, out_h, out_w, 3) uint8.
    """
    height, width = images.shape[1:3]
    params = convert.synthesis_params(params, images.device)

    # Geometric: the two-shear shifts + taps warp.
    x = apply_affine_warp(to_f32(images), params.warp_plan, warp_statics)

    # Photometric: contrast & brightness.
    c = params.contrasts[:, None, None, None]
    b = params.brightnesses[:, None, None, None]
    x = x * c + b

    # Gaussian noise, per-sample std.
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                        device=x.device)
    x = x + noise * params.noise_stds[:, None, None, None]
    x = torch.clamp(x, 0.0, 255.0)

    # JPEG roundtrip, per-sample quality tables, gated per sample: the
    # bit-exact integer libjpeg pipeline, which consumes a uint8 image, so
    # round first.
    x_u8 = round_u8(x)
    x_jpeg = jpeg_roundtrip_exact_torch(
        x_u8, params.luma_qtables, params.chroma_qtables
    )
    gate = params.jpeg_enables[:, None, None, None] > 0.5
    x = torch.where(gate, x_jpeg, x_u8).to(torch.float32)

    if out_shape is not None and tuple(out_shape) != (height, width):
        x = resize(x, out_shape, Interpolation.LINEAR)

    return round_u8(x)


def transform_label_points(
    params: SynthesisParams,
    np_points: np.ndarray,
    out_scale: Tuple[float, float] = (1.0, 1.0),
) -> np.ndarray:
    """Co-transform label points (host-side) through the batch geometry.

    ``np_points``: (N, P, 2) xy per sample.  Applies each sample's forward
    homography (the same matrix the warp inverts), then the final resize
    scale; mirrors the reference's point path in
    vkit/mechanism/distortion/geometric/affine.py:46-64.
    """
    mats = np.asarray(params.trans_mats, dtype=np.float64)
    np_points = np.asarray(np_points, dtype=np.float64)
    homo = np.concatenate(
        [np_points, np.ones_like(np_points[..., :1])], axis=-1
    )
    out = np.einsum('npk,njk->npj', homo, mats)
    denom = out[..., 2:3]
    denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    xy = out[..., :2] / denom
    xy[..., 0] *= out_scale[1]
    xy[..., 1] *= out_scale[0]
    return xy
