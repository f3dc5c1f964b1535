"""One photometric round over a batch: every sample its own drawn op.

Counterpart of vkit_tpu/mechanism/photometric_program.py.  The round's
semantics are the reference's ``_mega_round_core``:

    out[n] = clip(round(op_{sel[n]}(x)[n]))      (no draw: passthrough)

The reference computes all 16 ops over the whole batch and selects, so that
one XLA program serves every draw.  Eager PyTorch has no program to share,
so the round is a grouping over the per-name dispatch: each name applies
once, on the gathered sub-batch of the samples that drew it, which gives the
same values for the deterministic ops.  The round takes the draws by name,
the input of the reference's ``build_round_params``, instead of its
parameter table.  ``MEGA_NAMES`` and ``mega_covers``, which decides which
draws ride the round, are the reference's own code.
"""
import zlib
from typing import Tuple

from .batched import batch_distort_grouped

# Order defines each op's selection index; append-only.
MEGA_NAMES: Tuple[str, ...] = (
    'mean_shift',
    'color_shift',
    'brightness_shift',
    'std_shift',
    'boundary_equalization',
    'complement',
    'posterization',
    'color_balance',
    'channel_permutation',
    'gaussion_noise',
    'impulse_noise',
    'speckle_noise',
    'line_streak',
    'gaussian_blur',
    'defocus_blur',
    'motion_blur',
)

# Filter blurs ride the mega round as ONE per-sample KxK convolution
# (identity kernels for non-members).  Draws whose kernel exceeds the
# static width fall back to the per-name dispatch.
_BLUR_K = 7
_MEGA_INDEX = {name: i for i, name in enumerate(MEGA_NAMES)}


def mega_covers(name: str, config=None) -> bool:
    if name not in _MEGA_INDEX:
        return False
    if config is None:
        return True
    if name == 'gaussian_blur':
        from .distortion.photometric.blur import (
            estimate_gaussian_kernel_size,
        )
        return estimate_gaussian_kernel_size(float(config.sigma)) <= _BLUR_K
    if name == 'defocus_blur':
        return 2 * int(config.radius) + 1 <= _BLUR_K
    if name == 'motion_blur':
        return 2 * int(config.radius) + 1 <= _BLUR_K
    return True


__all__ = ['MEGA_NAMES', 'apply_mega_round', 'mega_covers']


def apply_mega_round(images, members_by_name, seed: int):
    """One photometric round over a uint8 (N, H, W, 3) batch; returns the
    new batch.  ``members_by_name``: {name: [(sample_idx, config)]}, at most
    one draw per sample, every draw one that ``mega_covers`` accepts.
    ``seed`` seeds the round; each rng-consuming op draws from its own
    stream of it."""
    for name, members in members_by_name.items():
        if not all(mega_covers(name, config) for _, config in members):
            raise ValueError(f'{name}: a draw the round does not cover')
    out = images
    for name, members in sorted(members_by_name.items()):
        name_seed = (seed + zlib.crc32(name.encode())) & 0xFFFFFFFF
        out = batch_distort_grouped(name, members, out, name_seed)
    return out
