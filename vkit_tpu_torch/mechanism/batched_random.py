"""Batched random geometric distortion on the device.

Port of vkit_tpu/mechanism/batched_random.py ``batch_random_geometric_distort``.
The policy draws are the reference's own host sampler
(``sample_geometric_plans``), so the same rng gives the same plans.
"""
import numpy as np
from numpy.random import Generator as RandomGenerator

from vkit_tpu.element import Box, Mask
from vkit_tpu.mechanism.batched_random import sample_geometric_plans
from vkit_tpu.mechanism.distortion.warp_plan import warp_active_mask

from .batched import batched_plan_warp


def batch_random_geometric_distort(
    images,
    level: int,
    rng: RandomGenerator,
    stage_config=None,
    device=None,
):
    """Apply a randomized geometric policy draw (exactly one, maybe
    disabled) to each batch sample, on a shared max-size canvas.

    ``images``: (N, H, W, C) tensor (or array, moved to ``device``).
    Returns (warped (N, Hmax, Wmax, C) tensor with the input dtype,
    active (N, Hmax, Wmax) uint8 numpy, content_boxes)."""
    n, height, width = images.shape[:3]
    plans = sample_geometric_plans(
        n, (height, width), level, rng, stage_config=stage_config
    )

    warped, shapes, _ = batched_plan_warp(plans, images, device=device)

    h_max = max(s[0] for s in shapes)
    w_max = max(s[1] for s in shapes)
    active = np.zeros((n, h_max, w_max), dtype=np.uint8)
    content_boxes = []
    for idx, plan in enumerate(plans):
        h, w = shapes[idx]
        active[idx, :h, :w] = warp_active_mask(plan).mat
        try:
            content_boxes.append(Mask(mat=active[idx]).to_external_box())
        except RuntimeError:
            content_boxes.append(Box(0, h - 1, 0, w - 1))
    return warped, active, content_boxes
