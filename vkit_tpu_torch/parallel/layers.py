"""The detector's collectives under a dp x sp x tp mesh, with their
backward rules (models/text_detection.py calls them).

XLA partitions the reference's sharded program and inserts these
collectives itself; the port writes each one as a ``torch.autograd
.Function`` on the plain collectives of one axis's process group:

  - ``exchange_halo`` (sp): a conv's input rows with the rows its 'SAME'
    window reads from the neighbouring sp ranks (zeros past the image's
    edges); backward returns the halo rows' gradients to their owners.
  - ``all_reduce_sum`` (sp): GroupNorm's sums over rows; backward is the
    same all-reduce.
  - ``copy_to_tp`` and ``gather_channels`` (tp): Megatron's *f* and *g*
    around a column-parallel conv.  *f* is the identity forward and sums
    the input's gradient over tp backward: each rank's slice of output
    channels gives only part of it.  *g* all-gathers the channels forward
    and takes this rank's slice of the gradient backward: what follows is
    replicated over tp, so every rank already holds the whole gradient,
    and a sum would count it tp times.

Tensors are NCHW (``channels_last`` memory in the net); the collectives
run on NHWC copies, which are contiguous.
"""
import torch

from .mesh import MODEL_AXIS, SPATIAL_AXIS

__all__ = ['all_reduce_sum', 'copy_to_tp', 'exchange_halo',
           'gather_channels', 'halo_rows']


def _all_reduce(x: torch.Tensor, mesh, axis: str):
    return mesh.all_reduce_(x.contiguous().clone(), (axis,))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x, mesh, axis: str = SPATIAL_AXIS):
    """Sum of ``x`` over ``axis``, on every rank of it, differentiable."""
    return _AllReduceSum.apply(x, mesh, axis)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        nhwc = grad.permute(0, 2, 3, 1)
        summed = _all_reduce(nhwc, ctx.mesh, MODEL_AXIS)
        return summed.permute(0, 3, 1, 2), None


def copy_to_tp(x, mesh):
    """Megatron's *f*: ``x`` as it is; its gradient summed over tp."""
    return _CopyToTP.apply(x, mesh)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.channels = x.shape[1]
        parts = mesh.all_gather(x.permute(0, 2, 3, 1), MODEL_AXIS)
        return torch.cat(parts, dim=3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.coordinate(MODEL_AXIS) * ctx.channels
        return grad[:, start:start + ctx.channels], None


def gather_channels(x, mesh):
    """Megatron's *g*: the tp ranks' channel slices of an NCHW tensor put
    together in rank order; backward keeps this rank's slice."""
    return _GatherChannels.apply(x, mesh)


def halo_rows(height: int, kernel: int, stride: int, sp: int):
    """(rows above, rows below) that the 'SAME' window of a conv reads
    beyond this rank's ``height`` input rows, when ``sp`` ranks each hold
    ``height`` rows of the image.  The image's own padding is
    ``_same_padding(height * sp, ...)`` = (above, below): on an even side a
    3x3 stride-2 conv reads one row below and none above, a stride-1 3x3
    one row each way, a 1x1 none."""
    if height % stride:
        raise ValueError(f'{height} rows a rank do not split by stride '
                         f'{stride}: the image side must be a multiple of '
                         f'sp * 2**stages')
    total = height * sp
    out = -(-total // stride)
    pad = max((out - 1) * stride + kernel - total, 0)
    above, below = pad // 2, pad - pad // 2
    if max(above, below) > height:
        raise ValueError(f'a halo of {(above, below)} rows over {height}')
    return above, below


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, above, below):
        ctx.mesh, ctx.above, ctx.below = mesh, above, below
        rank, size = mesh.coordinate(SPATIAL_AXIS), mesh.size(SPATIAL_AXIS)
        nhwc = x.permute(0, 2, 3, 1)
        h = nhwc.shape[1]
        # Each rank sends its first ``below`` rows (the halo of the rank
        # above) and its last ``above`` rows (that of the rank below).
        edges = torch.cat([nhwc[:, :below], nhwc[:, h - above:]], dim=1)
        parts = mesh.all_gather(edges, SPATIAL_AXIS)
        zeros = nhwc.new_zeros
        top = (parts[rank - 1][:, below:] if rank > 0
               else zeros((nhwc.shape[0], above) + nhwc.shape[2:]))
        bottom = (parts[rank + 1][:, :below] if rank < size - 1
                  else zeros((nhwc.shape[0], below) + nhwc.shape[2:]))
        return torch.cat([top, nhwc, bottom], dim=1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        mesh, above, below = ctx.mesh, ctx.above, ctx.below
        rank, size = mesh.coordinate(SPATIAL_AXIS), mesh.size(SPATIAL_AXIS)
        nhwc = grad.permute(0, 2, 3, 1)
        h = nhwc.shape[1] - above - below
        halo = torch.cat([nhwc[:, :above], nhwc[:, above + h:]], dim=1)
        parts = mesh.all_gather(halo, SPATIAL_AXIS)
        own = nhwc[:, above:above + h].clone()
        # The rank above read this rank's first rows as its bottom halo,
        # the rank below its last rows as its top halo.
        if rank > 0:
            own[:, :below] += parts[rank - 1][:, above:]
        if rank < size - 1:
            own[:, h - above:] += parts[rank + 1][:, :above]
        return own.permute(0, 3, 1, 2), None, None, None


def exchange_halo(x, kernel: int, stride: int, mesh):
    """NCHW ``x`` (this rank's rows of the image) with the rows that a
    'SAME' conv of ``kernel`` and ``stride`` reads from the neighbouring sp
    ranks above and below: the conv then pads the width only."""
    above, below = halo_rows(x.shape[2], kernel, stride,
                             mesh.size(SPATIAL_AXIS))
    if above == below == 0:
        return x
    return _ExchangeHalo.apply(x, mesh, above, below)
