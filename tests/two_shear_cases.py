"""Inputs of the two-shear warp's slab and blend kernels
(vkit_tpu_torch/ops/kernels.py ``quadrant_slab`` and ``line_blend``), and
the plain PyTorch ops that ops/warp_mxu.py composed in their place, which
the kernels' plain versions must equal bit for bit.  Imports neither jax
nor vkit_tpu, so that the card's tests can use it."""
import numpy as np
import torch

from vkit_tpu_torch import convert
from vkit_tpu_torch.ops import kernels as K
from vkit_tpu_torch.ops import warp_mxu
from vkit_tpu_torch.ops.warp import to_image_dtype

# Per-sample quadrants: all 0, all 1, 0-3 mixed on a square source, and 2
# (the only turn a non-square source takes) beside 0.
QUADRANT_KINDS = ('zero', 'one', 'mixed', 'non_square_two')
CHANNELS = (1, 4, 5, 7)
# A pass whose shifted span fits K1's 2048-lane window, and the spread
# split's, a 1400-lane source cut to 700, which takes K2.
ROUTES = ('k1', 'k2')
DTYPES = (torch.uint8, torch.float32)


def dtype_id(dtype) -> str:
    return str(dtype).rsplit('.', 1)[-1]


def slab_case(kind: str, channels: int, dtype, seed: int = 0):
    """(images (5, H, W, C) of ``dtype``, host quadrants (5,) int8)."""
    rng = np.random.default_rng(seed)
    h, w = (24, 41) if kind == 'non_square_two' else (37, 37)
    quadrants = {
        'zero': [0, 0, 0, 0, 0],
        'one': [1, 1, 1, 1, 1],
        'mixed': [0, 1, 2, 3, 1],
        'non_square_two': [2, 0, 2, 2, 0],
    }[kind]
    values = rng.integers(0, 256, (5, h, w, channels))
    if dtype == torch.float32:
        values = values + rng.random(values.shape)
    images = torch.from_numpy(values).to(dtype)
    return images, np.asarray(quadrants, np.int8)


def composed_slab(images, quadrants):
    """What ``quadrant_slab`` replaced: each sample's torch.rot90 written
    into a clone, the float32 cast, pass V's transpose and the copy that
    ``_shift_lines`` made of it."""
    out = images
    for k in (1, 2, 3):
        sel = np.flatnonzero(np.asarray(quadrants) == k)
        if len(sel) == 0:
            continue
        if out is images:
            out = images.clone()
        idx = torch.as_tensor(sel, device=images.device)
        out[idx] = torch.rot90(images[idx], k, (1, 2))
    return out.to(torch.float32).permute(0, 2, 3, 1).contiguous()


def line_plan(route: str, seed: int = 0):
    """(slopes (N,), offsets (N, L), m_in, m_out) of one resample pass."""
    rng = np.random.default_rng(seed)
    if route == 'k1':
        n, lines, m_in, m_out = 2, 9, 64, 80
        slopes = 0.8 + rng.uniform(-0.05, 0.05, n)
        offsets = (rng.uniform(-6, 6, (n, 1))
                   + np.linspace(0, 11.5, lines)[None, :])
    else:
        n, lines, m_in, m_out = 2, 6, 1400, 700
        slopes = 1.0 + rng.uniform(-0.002, 0.002, n)
        offsets = (rng.uniform(0, 690, (n, 1))
                   + np.linspace(0, 12, lines)[None, :])
    return slopes, offsets, m_in, m_out


def blend_case(route: str, channels: int, border: float, device='cpu',
               seed: int = 0):
    """(the shifted window as ``_shift_lines`` makes it on ``route``, the
    pass's plan on ``device``)."""
    slopes, offsets, m_in, m_out = line_plan(route, seed)
    plan, statics = warp_mxu.plan_line_resample(slopes, offsets, m_in, m_out)
    assert (m_in + statics.m_shift > K.WINDOW) == (route == 'k2')
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy((rng.random(
        (len(slopes), offsets.shape[1], channels, m_in)) * 255
    ).astype(np.float32)).to(device)
    plan = convert.line_resample_plan(plan, device)
    window = warp_mxu._shift_lines(x, plan.starts, statics, border)
    return window, plan


def composed_blend(window, plan, layout: str):
    """What ``line_blend`` replaced: apply_line_resample's three gathers
    and five-op hat blend, then the permute the two-pass applied (a view;
    the next pass's ``_shift_lines`` copied pass V's)."""
    n, l, c, _ = window.shape
    jn = plan.i0.shape[1]
    i0 = plan.i0.to(torch.int64)[:, None, None, :].expand(n, l, c, jn)
    a0 = torch.gather(window, 3, i0)
    a1 = torch.gather(window[..., 1:], 3, i0)
    a2 = torch.gather(window[..., 2:], 3, i0)
    u = plan.frac_j[:, None, :] + plan.phi[:, :, None]
    w0 = torch.clamp(1.0 - u, min=0.0)
    w2 = torch.clamp(u - 1.0, min=0.0)
    w1 = 1.0 - w0 - w2
    w0, w1, w2 = (w[:, :, None, :] for w in (w0, w1, w2))
    out = a0 * w0 + a1 * w1 + a2 * w2
    return out.permute(*K.LINE_BLEND_LAYOUTS[layout])


def composed_affine_warp(images, quadrants, plan, statics, border: float):
    """The whole two-shear warp as ops/warp_mxu.py composed it before the
    slab and blend kernels: (N, H, W, C) -> (N, H_out, W_out, C)."""
    x_v = composed_slab(images, quadrants)
    shifted = warp_mxu._shift_lines(x_v, plan.pass_v.starts,
                                    statics.statics_v, border)
    x_h = composed_blend(shifted, plan.pass_v, 'njcl').contiguous()
    shifted = warp_mxu._shift_lines(x_h, plan.pass_h.starts,
                                    statics.statics_h, border)
    out = composed_blend(shifted, plan.pass_h, 'nljc')
    return to_image_dtype(out, images.dtype)


def affine_case(kind: str, dtype, device='cpu', seed: int = 0):
    """(images (5, H, W, 5), quadrants, plan on ``device``, statics): each
    sample turned by an angle its quadrant kind implies, planned as
    mechanism/batched.py plans its affine route (quadrant reduction and
    the canonical statics)."""
    images, _ = slab_case(kind, 5, dtype, seed)
    n, h, w = images.shape[:3]
    angles = {
        'zero': [5, -12, 30, -40, 0],
        'one': [-80, -95, -120, -70, -100],
        'mixed': [10, 85, 175, -95, 60],
        'non_square_two': [170, -20, 185, 200, 15],
    }[kind]
    mats = np.tile(np.eye(3), (n, 1, 1))
    for i, deg in enumerate(angles):
        rad = np.deg2rad(deg)
        turn = np.asarray([[np.cos(rad), -np.sin(rad)],
                           [np.sin(rad), np.cos(rad)]])
        mats[i, :2, :2] = turn
        mats[i, :2, 2] = np.asarray([w, h]) / 2 - turn @ (np.asarray([w, h])
                                                          / 2)
    quadrants, reduced = warp_mxu.quadrant_reduce_mats(mats, (h, w))
    plan, statics = warp_mxu.plan_affine_warp(reduced, (h, w), (h + 6, w + 4),
                                              canonical=True)
    return (images.to(device), quadrants,
            convert.affine_warp_plan(plan, device), statics)


def rotate_call(device, seed: int = 17):
    """One warp of the rotate cell (cardbench's distort-640.rotate): a
    stack of its shape, 32 x 640 x 640 x 5 (RGB noise, ones, a uniform
    plane), and per-sample rotate plans of 73-89 degrees either way,
    through ``batched_plan_warp``."""
    from vkit_tpu_torch.mechanism import distortion
    from vkit_tpu_torch.mechanism.batched import batched_plan_warp

    rng = np.random.default_rng(seed)
    n, side = 32, 640
    stack = torch.empty((n, side, side, 5), dtype=torch.float32,
                        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack[..., :3] = torch.randint(0, 256, (n, side, side, 3), generator=gen,
                                   device=device, dtype=torch.uint8)
    stack[..., 3] = 1.0
    stack[..., 4] = torch.rand((n, side, side), generator=gen, device=device)
    angles = rng.integers(73, 90, n) * rng.choice([-1, 1], n)
    plans = [distortion.rotate.plan({'angle': int(a)}, (side, side), rng)
             for a in angles]
    return lambda: batched_plan_warp(plans, stack)


def flatten_call(device, seed: int = 23):
    """One text-region flatten chunk at the shape of the largest in a
    synth-640 batch: 1024 patches of 64 x 64 x 4 into 256 x 256 tiles."""
    from vkit_tpu_torch.ops.region import batch_flatten_regions

    rng = np.random.default_rng(seed)
    r = 1024
    patches = torch.from_numpy(
        rng.random((r, 64, 64, 4), dtype=np.float32)).to(device)
    angles = rng.uniform(-180, 180, r)
    scales = rng.uniform(2.0, 3.5, r)
    return lambda: batch_flatten_regions(patches, angles, scales, 256)
