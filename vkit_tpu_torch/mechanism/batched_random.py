"""Batched RandomDistortion on the device: policy draws on the host, the
photometric rounds and the geometric warp on the device.

Port of vkit_tpu/mechanism/batched_random.py
``batch_random_photometric_distort``, ``batch_random_geometric_distort`` and
``batch_random_distort``.  The policy draws are the reference's own host
samplers, called in the same order on the same rng, so the same rng gives
the same policies, configs and plans, draw for draw, and leaves the rng in
the same state.  The reference's jax ``key`` becomes an integer ``seed``
that takes the place of the drawn base seed.
"""
import zlib
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np
import torch
from numpy.random import Generator as RandomGenerator

from vkit_tpu.element import Box, Mask
from vkit_tpu.mechanism.batched_random import sample_geometric_plans
from vkit_tpu.mechanism.distortion.warp_plan import warp_active_mask
from vkit_tpu.mechanism.distortion_policy.random_distortion import (
    RandomDistortionStage,
    RandomDistortionStageConfig,
    random_distortion_factory,
)

from .batched import batch_distort_grouped, batched_plan_warp
from .photometric_program import apply_mega_round, mega_covers


def sample_photometric_sequences(
    n: int,
    shape: Tuple[int, int],
    level: int,
    rng: RandomGenerator,
    stage_config: Optional[RandomDistortionStageConfig] = None,
    seed: Optional[int] = None,
) -> Tuple[int, List[list]]:
    """Host draws of the photometric stage, in the reference's order:
    the base seed (unless ``seed`` is given), then per sample
    ``rng.random()``, the policy draw and each policy's config.  Returns
    (base_seed, per-sample [(name, config)] sequences)."""
    if stage_config is None:
        stage_config = (
            random_distortion_factory.create_photometric_stage_config()
        )
    stage = RandomDistortionStage(stage_config)
    base_seed = int(rng.integers(0, 2**31 - 1)) if seed is None else int(seed)
    sequences = []
    for _ in range(n):
        policies = ()
        if rng.random() <= stage_config.prob_enable:
            policies = stage.sample_distortion_policies(rng)
        sequences.append([
            (policy.name, policy.sample_config(level, shape, rng))
            for policy in policies
        ])
    return base_seed, sequences


def batch_random_photometric_distort(
    images,
    level: int,
    rng: RandomGenerator,
    seed: Optional[int] = None,
    stage_config: Optional[RandomDistortionStageConfig] = None,
):
    """Apply a randomized photometric policy draw to each batch sample.

    ``images``: (N, H, W, 3) uint8 tensor on the device that runs the
    stage.  Returns the distorted batch as a new tensor.  Round by round,
    in the reference's order and seed schedule: the draws ``mega_covers``
    accepts apply as one round (photometric_program.py), then the other
    names, sorted, each through the per-name dispatch."""
    if not isinstance(images, torch.Tensor) or images.dtype != torch.uint8:
        raise TypeError('images must be a uint8 torch.Tensor')
    n, height, width = images.shape[:3]
    base_seed, sequences = sample_photometric_sequences(
        n, (height, width), level, rng, stage_config, seed
    )

    out = images
    for round_idx in range(max((len(seq) for seq in sequences), default=0)):
        mega_members = defaultdict(list)
        name_to_members = defaultdict(list)
        for sample_idx, seq in enumerate(sequences):
            if round_idx < len(seq):
                name, config = seq[round_idx]
                covered = mega_covers(name, config)
                (mega_members if covered else name_to_members)[name].append(
                    (sample_idx, config))
        if mega_members:
            seed_r = (base_seed + 0x9E3779B1 * (round_idx + 1)) & 0xFFFFFFFF
            out = apply_mega_round(out, mega_members, seed_r)
        for name, members in sorted(name_to_members.items()):
            name_seed = (
                base_seed + 0x85EBCA77 * (round_idx + 1)
                + zlib.crc32(name.encode())
            ) & 0xFFFFFFFF
            out = batch_distort_grouped(name, members, out, name_seed)
    return out


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


def batch_random_distort(
    images,
    level: int,
    rng: RandomGenerator,
    seed: Optional[int] = None,
    factory_config=None,
):
    """Full randomized distortion for a uint8 (N, H, W, 3) tensor batch:
    the photometric stage, then the geometric stage, with the trim folded
    into per-sample content boxes.

    Returns (images (N, Hmax, Wmax, C) uint8 tensor, active (N, Hmax, Wmax)
    uint8 numpy, content_boxes)."""
    photometric_cfg = random_distortion_factory.create_photometric_stage_config(
        factory_config
    )
    geometric_cfg = random_distortion_factory.create_geometric_stage_config(
        factory_config
    )
    out = batch_random_photometric_distort(
        images, level, rng, seed=seed, stage_config=photometric_cfg,
    )
    return batch_random_geometric_distort(
        out, level, rng, stage_config=geometric_cfg
    )
