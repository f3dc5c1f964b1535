"""State shared with the JAX package, carried over as torch tensors.

The port reuses vkit_tpu's host planners.  Their plans and placement tables
are numpy arrays, except where a planner caches a device constant as a jax
array (``warp_banded._cached_node_weights``, ``batched._interp_weights``).
Every array goes through ``np.asarray`` here, so no jax array ever reaches
torch and both packages start from the same numbers.
"""
import numpy as np
import torch

from vkit_tpu.ops.glyph import GlyphPlacements
from vkit_tpu.ops.warp_banded import BandedPassPlan, BandedWarpPlan
from vkit_tpu.ops.warp_mxu import AffineWarpPlan, LineResamplePlan


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           'available')
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {device}')
    return device


def to_tensor(array, device, dtype=None) -> torch.Tensor:
    """numpy / jax / torch array -> contiguous tensor on ``device``."""
    if isinstance(array, torch.Tensor):
        out = array.to(device)
        return (out if dtype is None else out.to(dtype)).contiguous()
    host = np.ascontiguousarray(np.asarray(array))
    if not host.flags.writeable:  # a view of a jax array or a frozen mat
        host = host.copy()
    out = torch.from_numpy(host).to(device)
    return (out if dtype is None else out.to(dtype)).contiguous()


def line_resample_plan(plan: LineResamplePlan, device) -> LineResamplePlan:
    return LineResamplePlan(
        i0=to_tensor(plan.i0, device, torch.int32),
        frac_j=to_tensor(plan.frac_j, device, torch.float32),
        starts=to_tensor(plan.starts, device, torch.int32),
        phi=to_tensor(plan.phi, device, torch.float32),
    )


def affine_warp_plan(plan: AffineWarpPlan, device) -> AffineWarpPlan:
    return AffineWarpPlan(
        pass_v=line_resample_plan(plan.pass_v, device),
        pass_h=line_resample_plan(plan.pass_h, device),
    )


def banded_pass_plan(plan: BandedPassPlan, device) -> BandedPassPlan:
    return BandedPassPlan(
        base=to_tensor(plan.base, device, torch.int32),
        nodes=to_tensor(plan.nodes, device, torch.float32),
        w_l=to_tensor(plan.w_l, device, torch.float32),
        w_j=to_tensor(plan.w_j, device, torch.float32),
    )


def banded_warp_plan(plan: BandedWarpPlan, device) -> BandedWarpPlan:
    return BandedWarpPlan(
        pass_v=banded_pass_plan(plan.pass_v, device),
        pass_h=banded_pass_plan(plan.pass_h, device),
    )


def glyph_placements(placements: GlyphPlacements, device) -> GlyphPlacements:
    """Placement table on ``device`` (int32 ids and boxes, float32 rest)."""
    ints = ('glyph_ids', 'sample_ids', 'ups', 'lefts', 'dst_hs', 'dst_ws')
    return GlyphPlacements(**{
        name: to_tensor(
            getattr(placements, name), device,
            torch.int32 if name in ints else torch.float32,
        )
        for name in GlyphPlacements._fields
    })


def atlas_tiles(tiles, device) -> torch.Tensor:
    """(V, T, T) float32 glyph tile array on ``device``."""
    return to_tensor(tiles, device, torch.float32)
