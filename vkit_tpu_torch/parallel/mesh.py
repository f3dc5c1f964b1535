"""Device mesh construction + sharding helpers.

Port of vkit_tpu/parallel/mesh.py to ``torch.distributed``.  One process
drives one device (one rank per GPU; one gloo rank per CPU "device"), and
the ranks are laid out as a dp x sp x tp mesh: the batch is split over
``dp``, activation rows over ``sp`` and the output channels of wide convs
over ``tp``.  XLA inserts the collectives of a sharded program by itself;
here they are code (parallel/layers.py, models/train.py), written on the
plain collectives of each axis's process group.

The tensors stay plain local shards (no DTensor): a ``Sharding`` says which
mesh axis splits which dim, ``put`` cuts this rank's slice out of a global
value that every rank holds, and ``gather`` puts the global value back
together from the slices.
"""
import collections
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import nested_to_device, resolve_device

DATA_AXIS = 'dp'
SPATIAL_AXIS = 'sp'
MODEL_AXIS = 'tp'

DEFAULT_AXIS_NAMES = (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS)


def factor_devices(n_devices: int, n_axes: int) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``n_axes`` mesh dims, biggest first.

    Greedy: repeatedly peel the largest prime factor onto the smallest axis,
    so 8 -> (2, 2, 2), 4 -> (2, 2, 1), 6 -> (3, 2, 1), 1 -> (1, 1, 1).
    """
    assert n_devices >= 1 and n_axes >= 1
    factors = []
    n = n_devices
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    dims = [1] * n_axes
    for f in sorted(factors, reverse=True):
        dims[int(np.argmin(dims))] *= f
    return tuple(sorted(dims, reverse=True))


class Mesh:
    """The ranks of the world laid out on named axes, as seen by this rank:
    each axis's size (``shape``), this rank's coordinate on it and its
    process group, and the device this rank computes on.

    A single process without a process group is a mesh of size 1 on every
    axis, with no groups: the sharded code then runs no collective.
    ``traffic`` counts the bytes this rank handed to each kind of
    collective."""

    def __init__(self, device_mesh, axis_names: Sequence[str],
                 device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.device = device
        if device_mesh is None:
            self.shape = {name: 1 for name in self.axis_names}
        else:
            self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.traffic = collections.Counter()
        self._groups = {}

    @property
    def has_groups(self) -> bool:
        return self.device_mesh is not None

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coordinate(self, axis: str) -> int:
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axes):
        """The process group of one axis, or of several axes as one: the
        ranks that share this rank's coordinates on every other axis.  A
        group of several axes is made at its first use, which every rank
        of the world must reach (as it does a collective)."""
        if isinstance(axes, str):
            return self.device_mesh.get_group(axes)
        axes = tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            dims = [self.axis_names.index(axis) for axis in axes]
            rest = [d for d in range(len(self.axis_names)) if d not in dims]
            members = self.device_mesh.mesh.permute(rest + dims).reshape(
                -1, int(np.prod([self.size(axis) for axis in axes])))
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                members.tolist())
        return self._groups[axes]

    def all_reduce_(self, tensor: torch.Tensor, axes: Sequence[str]):
        """Sum ``tensor`` in place over the product of ``axes`` (those the
        mesh has), in one collective without autograd.  Runs whenever the
        mesh has process groups, over axes of size 1 too."""
        axes = tuple(axis for axis in axes if axis in self.shape)
        if not self.has_groups or not axes:
            return tensor
        self.traffic['all_reduce'] += tensor.numel() * tensor.element_size()
        dist.all_reduce(tensor, group=self.group(axes))
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str):
        """The ranks' ``tensor``s along ``axis``, in coordinate order."""
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.size(axis))]
        self.traffic['all_gather'] += tensor.numel() * tensor.element_size()
        dist.all_gather(parts, tensor, group=self.group(axis))
        return parts

    def __repr__(self):
        return f'Mesh({self.shape}, device={self.device})'


def _device(device_type: str) -> torch.device:
    device = resolve_device(device_type)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    device_type: str = 'cuda',
) -> Mesh:
    """The mesh over the world's ranks, one device each.

    ``factor_devices`` gives the dims: 8 ranks make a (2, 2, 2) dp x sp x
    tp mesh, and a single process makes (1, 1, 1), so the same sharded
    program runs unchanged.  ``n_devices`` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f'{n_devices} devices asked for, the world has '
                         f'{world} ranks (one device each)')
    device = _device(device_type)
    if not dist.is_initialized():
        return Mesh(None, axis_names, device)
    dims = factor_devices(n_devices, len(axis_names))
    return Mesh(init_device_mesh(device.type, dims,
                                 mesh_dim_names=tuple(axis_names)),
                axis_names, device)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device_type: str = 'cuda',
) -> int:
    """Join the world's process group; returns the world size.

    Arguments left out come from torchrun's variables (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``; ``MASTER_ADDR`` / ``MASTER_PORT`` for the
    default ``env://`` rendezvous).  The backend is NCCL on a card, where
    the rank first selects device ``LOCAL_RANK`` (else its rank), and gloo
    on the CPU.  A single process with no ``init_method`` joins nothing.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get('WORLD_SIZE', '1'))
    if rank is None:
        rank = int(os.environ.get('RANK', '0'))
    if world_size <= 1 and init_method is None:
        return 1
    device = resolve_device(device_type)
    if device.type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', rank)))
    dist.init_process_group(
        'nccl' if device.type == 'cuda' else 'gloo',
        init_method=init_method or 'env://',
        world_size=world_size, rank=rank,
    )
    return world_size


def multihost_layout(
    world: int,
    local_world: int,
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    dcn_axis: str = DATA_AXIS,
) -> np.ndarray:
    """The ranks of ``world`` (``local_world`` a node, numbered node by
    node) on the mesh's axes: ``dcn_axis`` spans the nodes and the other
    axes factor the ranks of one node, so their collectives never leave a
    node."""
    if world % local_world:
        raise ValueError(f'{world} ranks do not fill nodes of {local_world}')
    axis_names = tuple(axis_names)
    nodes = world // local_world
    local_dims = factor_devices(local_world, len(axis_names) - 1)
    ranks = np.arange(world).reshape((nodes,) + local_dims)
    return np.moveaxis(ranks, 0, axis_names.index(dcn_axis))


def make_multihost_mesh(
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    dcn_axis: str = DATA_AXIS,
    device_type: str = 'cuda',
) -> Mesh:
    """Mesh over all ranks with ``dcn_axis`` spanning the nodes
    (``WORLD_SIZE / LOCAL_WORLD_SIZE`` of them); a single node reduces to
    ``make_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if world <= local_world:
        return make_mesh(axis_names=axis_names, device_type=device_type)
    device = _device(device_type)
    layout = multihost_layout(world, local_world, axis_names, dcn_axis)
    return Mesh(DeviceMesh(device.type, torch.from_numpy(layout),
                           mesh_dim_names=tuple(axis_names)),
                axis_names, device)


class Sharding(NamedTuple):
    """A placement on ``mesh``: ``spec`` gives one axis name or None per
    leading dim of a tensor, as a ``PartitionSpec`` does; dims past the
    spec are whole."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def batch_sharding(mesh: Mesh, ndim: int = 4) -> Sharding:
    """Sharding for an image batch (N, H, W, C): N over dp, H over sp."""
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    if ndim >= 3 and SPATIAL_AXIS in mesh.axis_names:
        spec[1] = SPATIAL_AXIS
    return Sharding(mesh, tuple(spec))


def data_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Leading-axis data sharding (labels, params): N over dp only."""
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_params_for_tp(params, mesh: Mesh, min_channels: int = 256):
    """{name: Sharding} for a state_dict: conv kernels (cout, cin, kh, kw)
    with ``cout >= min_channels`` and ``cout`` divisible by tp get their
    output-channel axis (dim 0) split over ``tp``; everything else, the
    1-D GroupNorm parameters and biases included, is replicated.  flax's
    kernels keep cout last, the port's first: the same parameters split."""
    tp_size = mesh.size(MODEL_AXIS)

    def spec_for(x) -> Sharding:
        if (tp_size > 1 and x.dim() >= 2 and x.shape[0] >= min_channels
                and x.shape[0] % tp_size == 0):
            return Sharding(mesh, (MODEL_AXIS,) + (None,) * (x.dim() - 1))
        return replicated(mesh)

    return {name: spec_for(value) for name, value in params.items()}


def _is_array(value) -> bool:
    return isinstance(value, (torch.Tensor, np.ndarray))


def _map(fn, tree, sharding):
    """``fn(leaf, sharding)`` on every array leaf of a nesting of tuples
    (NamedTuples keep their type), lists and dicts.  ``sharding`` is one
    Sharding for every leaf, or a nesting of the same structure, where None
    leaves its subtree as it is."""
    if sharding is None:
        return tree
    if _is_array(tree):
        if not isinstance(sharding, Sharding):
            raise TypeError(f'a tensor met a sharding tree: {type(sharding)}')
        return fn(tree, sharding)
    split = not isinstance(sharding, Sharding)
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_map(fn, value, sharding[i] if split else sharding)
                            for i, value in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, value, sharding[i] if split else sharding)
                          for i, value in enumerate(tree))
    if isinstance(tree, dict):
        return {key: _map(fn, value, sharding[key] if split else sharding)
                for key, value in tree.items()}
    return tree


def _split_dims(x, sharding: Sharding):
    """[(dim, axis)] of the dims that ``sharding`` splits over an axis of
    size > 1."""
    if len(sharding.spec) > x.ndim:
        raise ValueError(f'spec {sharding.spec} for a {x.ndim}-d value')
    return [(dim, axis) for dim, axis in enumerate(sharding.spec)
            if axis is not None and sharding.mesh.size(axis) > 1]


def local_slice(tree, sharding):
    """This rank's slices of the global arrays in ``tree``, where they lie
    (numpy stays numpy); no collective."""

    def cut(x, sharding):
        index = [slice(None)] * x.ndim
        for dim, axis in _split_dims(x, sharding):
            parts = sharding.mesh.size(axis)
            if x.shape[dim] % parts:
                raise ValueError(f'dim {dim} of {tuple(x.shape)} does not '
                                 f'split over {axis}={parts}')
            size = x.shape[dim] // parts
            start = sharding.mesh.coordinate(axis) * size
            index[dim] = slice(start, start + size)
        if isinstance(x, np.ndarray):
            return np.ascontiguousarray(x[tuple(index)])
        # A copy: the slice must not hold the global tensor alive.
        return x[tuple(index)].clone(memory_format=torch.contiguous_format)

    return _map(cut, tree, sharding)


def put(tree, sharding):
    """This rank's slices of the global values in ``tree`` (every rank holds
    the same), on the mesh's device: the dry run's
    ``jax.make_array_from_callback``."""

    def one(x, sharding):
        return nested_to_device(local_slice(x, sharding), sharding.mesh.device)

    return _map(one, tree, sharding)


def gather(tree, sharding):
    """The inverse of ``put``: the global values, on every rank, from the
    slices that the ranks hold (all-gathers over the split axes)."""

    def one(x, sharding):
        for dim, axis in reversed(_split_dims(x, sharding)):
            x = torch.cat(sharding.mesh.all_gather(x, axis), dim=dim)
        return x

    return _map(one, tree, sharding)


def _shardings(tree):
    if isinstance(tree, Sharding):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _shardings(value)
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            yield from _shardings(value)


def mesh_of(sharding) -> Mesh:
    """The mesh of the first Sharding in a nesting of them."""
    for found in _shardings(sharding):
        return found.mesh
    raise ValueError('no Sharding found')
