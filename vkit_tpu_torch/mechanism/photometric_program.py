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
parameter table.  ``mega_covers`` decides, as there, which draws ride the
round.
"""
import zlib

from vkit_tpu.mechanism.photometric_program import MEGA_NAMES, mega_covers

from .batched import batch_distort_grouped

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
