"""Host plans and tables, carried over to a device as torch tensors.

The host planners (ops/warp_mxu.py, ops/warp_banded.py, ops/glyph.py,
engine/font/atlas.py) build numpy arrays; the helpers here move a whole
plan or table onto a device with the dtype each field needs, keeping its
NamedTuple type.
"""
import numpy as np
import torch


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
    """numpy array (or tensor) -> contiguous tensor on ``device``."""
    if isinstance(array, torch.Tensor):
        out = array.to(device)
        return (out if dtype is None else out.to(dtype)).contiguous()
    host = np.ascontiguousarray(np.asarray(array))
    if not host.flags.writeable:  # a frozen element mat
        host = host.copy()
    out = torch.from_numpy(host).to(device)
    return (out if dtype is None else out.to(dtype)).contiguous()


def line_resample_plan(plan, device):
    """ops.warp_mxu.LineResamplePlan on ``device``."""
    return plan._replace(
        i0=to_tensor(plan.i0, device, torch.int32),
        frac_j=to_tensor(plan.frac_j, device, torch.float32),
        starts=to_tensor(plan.starts, device, torch.int32),
        phi=to_tensor(plan.phi, device, torch.float32),
    )


def affine_warp_plan(plan, device):
    """ops.warp_mxu.AffineWarpPlan on ``device``."""
    return plan._replace(
        pass_v=line_resample_plan(plan.pass_v, device),
        pass_h=line_resample_plan(plan.pass_h, device),
    )


def banded_pass_plan(plan, device):
    """ops.warp_banded.BandedPassPlan on ``device``."""
    return plan._replace(
        base=to_tensor(plan.base, device, torch.int32),
        nodes=to_tensor(plan.nodes, device, torch.float32),
        w_l=to_tensor(plan.w_l, device, torch.float32),
        w_j=to_tensor(plan.w_j, device, torch.float32),
    )


def banded_warp_plan(plan, device):
    """ops.warp_banded.BandedWarpPlan on ``device``."""
    return plan._replace(
        pass_v=banded_pass_plan(plan.pass_v, device),
        pass_h=banded_pass_plan(plan.pass_h, device),
    )


def glyph_placements(placements, device):
    """ops.glyph.GlyphPlacements on ``device`` (int32 ids and boxes,
    float32 rest)."""
    ints = ('glyph_ids', 'sample_ids', 'ups', 'lefts', 'dst_hs', 'dst_ws')
    return placements._replace(**{
        name: to_tensor(
            getattr(placements, name), device,
            torch.int32 if name in ints else torch.float32,
        )
        for name in placements._fields
    })


def atlas_tiles(tiles, device) -> torch.Tensor:
    """(V, T, T) float32 glyph tile array on ``device``."""
    return to_tensor(tiles, device, torch.float32)
