"""Host plans and tables, carried over to a device as torch tensors; the
detector's weights, carried between the flax layout and the port's.

The host planners (ops/warp_mxu.py, ops/warp_banded.py, ops/glyph.py,
engine/font/atlas.py, parallel/batch.py) build numpy arrays; the helpers
here move a whole plan or table onto a device with the dtype each field
needs, keeping its NamedTuple type.
"""
import numpy as np
import torch


class DeviceError(RuntimeError):
    """A fault of the device layer: no card where one was asked for, or a
    kernel that does not build or launch.  A new random draw cannot mend
    it, so the pools pass it to their caller instead of retrying."""


def is_device_error(error: BaseException) -> bool:
    """``error`` is a DeviceError, or a CUDA error raised by torch: an
    out-of-memory, a failed launch or sync, a card that cannot be
    initialised (none present, or a forked child of a CUDA parent)."""
    if isinstance(error, (DeviceError, torch.cuda.OutOfMemoryError)):
        return True
    accelerator_error = getattr(torch, 'AcceleratorError', None)
    if accelerator_error is not None and isinstance(error, accelerator_error):
        return True
    return isinstance(error, (RuntimeError, AssertionError)) \
        and 'CUDA' in str(error)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise DeviceError(f'device {device} requested but CUDA is not '
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


def nested_to_device(value, device, non_blocking: bool = False):
    """Every array or tensor in a nesting of tuples (NamedTuples keep
    their type), lists and dicts on ``device``; other leaves as they are.
    With ``non_blocking`` a host tensor is pinned first, so that its copy
    to a card can run beside the host."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, torch.Tensor):
        if non_blocking and value.device.type == 'cpu':
            value = value.pin_memory()
        return value.to(device, non_blocking=non_blocking)
    if isinstance(value, tuple) and hasattr(value, '_fields'):
        return type(value)(*(nested_to_device(v, device, non_blocking)
                             for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(nested_to_device(v, device, non_blocking)
                           for v in value)
    if isinstance(value, dict):
        return {k: nested_to_device(v, device, non_blocking)
                for k, v in value.items()}
    return value


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


def synthesis_params(params, device):
    """parallel.batch.SynthesisParams on ``device`` (quant tables int32,
    the rest float32)."""
    ints = ('luma_qtables', 'chroma_qtables')
    return params._replace(
        warp_plan=affine_warp_plan(params.warp_plan, device),
        **{
            name: to_tensor(
                getattr(params, name), device,
                torch.int32 if name in ints else torch.float32,
            )
            for name in params._fields if name != 'warp_plan'
        },
    )


def dense_line_plan(plan, device):
    """ops.warp_mxu.DenseLinePlan on ``device``."""
    return plan._replace(
        i0=to_tensor(plan.i0, device, torch.int32),
        starts=to_tensor(plan.starts, device, torch.int32),
        u=to_tensor(plan.u, device, torch.float32),
    )


def dense_warp_plan(plan, device):
    """ops.warp_mxu.DenseWarpPlan on ``device``."""
    return plan._replace(
        pass_v=dense_line_plan(plan.pass_v, device),
        pass_h=dense_line_plan(plan.pass_h, device),
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


# ---------------------------------------------------------------------------
# The detector's weights: flax ``params`` (nested dicts of numpy arrays)
# <-> models.TextDetectionNet's state_dict.
# ---------------------------------------------------------------------------


def _detector_names(num_stages: int):
    """[(flax path, state_dict prefix, 'conv' or 'norm')] for a detector of
    ``num_stages`` stages.  flax numbers the modules of a compact
    ``__call__`` in call order: the table spells that order out (sorting
    the names as strings would put ``Conv_10`` before ``Conv_2``)."""
    names = []
    for i in range(num_stages):
        block = f'ConvBlock_{i}'
        names += [
            ((block, 'Conv_0'), f'stages.{i}.conv1', 'conv'),
            ((block, 'GroupNorm_0'), f'stages.{i}.norm1', 'norm'),
            ((block, 'Conv_1'), f'stages.{i}.conv2', 'conv'),
            ((block, 'GroupNorm_1'), f'stages.{i}.norm2', 'norm'),
        ]
    names.append((('Conv_0',), 'top', 'conv'))
    for i in range(num_stages - 1):
        names.append(((f'Conv_{1 + 2 * i}',), f'laterals.{i}', 'conv'))
        names.append(((f'Conv_{2 + 2 * i}',), f'smooths.{i}', 'conv'))
    for k, head in enumerate(('mask_head', 'height_head', 'gaussian_head')):
        names.append(((f'Conv_{2 * num_stages - 1 + k}',), head, 'conv'))
    return names


def detector_state_from_flax(params, device='cpu'):
    """flax ``params`` of vkit_tpu's TextDetectionNet (nested dicts of
    arrays) -> the port's state_dict on ``device``.  Conv kernels go from
    (kh, kw, cin, cout) to (cout, cin, kh, kw); GroupNorm's ``scale`` is
    ``weight``."""
    num_stages = sum(name.startswith('ConvBlock_') for name in params)
    table = _detector_names(num_stages)
    if len(params) != len({path[0] for path, _, _ in table}):
        raise ValueError(f'not a detector\'s params: {sorted(params)}')
    state = {}
    for path, prefix, kind in table:
        leaf = params
        for name in path:
            leaf = leaf[name]
        if kind == 'conv':
            kernel = np.asarray(leaf['kernel'], dtype=np.float32)
            state[f'{prefix}.weight'] = to_tensor(
                kernel.transpose(3, 2, 0, 1), device)
        else:
            state[f'{prefix}.weight'] = to_tensor(
                np.asarray(leaf['scale'], dtype=np.float32), device)
        if 'bias' in leaf:
            state[f'{prefix}.bias'] = to_tensor(
                np.asarray(leaf['bias'], dtype=np.float32), device)
    return state


def detector_state_to_flax(state):
    """The reverse of ``detector_state_from_flax``: nested dicts of numpy
    arrays in the flax layout."""
    num_stages = len({name.split('.')[1] for name in state
                      if name.startswith('stages.')})
    params = {}
    for path, prefix, kind in _detector_names(num_stages):
        leaf = params
        for name in path:
            leaf = leaf.setdefault(name, {})
        weight = state[f'{prefix}.weight'].detach().cpu().numpy()
        if kind == 'conv':
            leaf['kernel'] = np.ascontiguousarray(weight.transpose(2, 3, 1, 0))
        else:
            leaf['scale'] = weight
        if f'{prefix}.bias' in state:
            leaf['bias'] = state[f'{prefix}.bias'].detach().cpu().numpy()
    return params
