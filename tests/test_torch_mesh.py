"""The port's device mesh (vkit_tpu_torch/parallel/mesh.py) against
vkit_tpu's: mesh factoring, the multi-node layout, the sharding specs,
put / gather, the parameters that tp splits, the sharded prefetch and the
dp-sharded photometric round.

Ranks are spawned (start method spawn: this process has jax loaded), one
gloo rank per CPU "device", and meet through a FileStore under a temporary
directory.  This module imports jax and vkit_tpu only inside the functions
that run the reference: a spawned rank imports it and must load neither.
The rank bodies are the ``_*_body`` functions; each rank saves what it saw
for the tests to read.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vkit_tpu_torch import convert
from vkit_tpu_torch import models as TM
from vkit_tpu_torch import parallel as TP
from vkit_tpu_torch.parallel.layers import halo_rows
from vkit_tpu_torch.parallel.mesh import local_slice, multihost_layout

torch.set_num_threads(1)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vkit_tpu')
FULL_WIDTH = dict(stage_features=(64, 128, 256, 512), fpn_features=128)


# ---------------------------------------------------------------------------
# Spawning ranks.
# ---------------------------------------------------------------------------


def _rank(rank, body, world, root):
    torch.set_num_threads(1)
    TP.initialize_distributed(f'file://{root}/store_{body.__name__}', world,
                              rank, device_type='cpu')
    try:
        result = body(rank, Path(root))
        result['loaded'] = sorted(name for name in sys.modules
                                  if name.split('.')[0] in FORBIDDEN)
        torch.save(result, Path(root) / f'{body.__name__}_{rank}.pt')
    finally:
        dist.destroy_process_group()


def spawn(body, world, root):
    """Run ``body(rank, root)`` on ``world`` gloo ranks; returns what each
    rank's body returned (a dict), in rank order."""
    mp.start_processes(_rank, args=(body, world, str(root)), nprocs=world,
                       start_method='spawn')
    return [torch.load(Path(root) / f'{body.__name__}_{rank}.pt',
                       weights_only=False) for rank in range(world)]


# ---------------------------------------------------------------------------
# Without ranks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('n,axes,dims', [
    (8, 3, (2, 2, 2)), (4, 3, (2, 2, 1)), (6, 3, (3, 2, 1)),
    (1, 3, (1, 1, 1)), (16, 2, (4, 4)),
])
def test_factor_devices(n, axes, dims):
    from vkit_tpu.parallel import factor_devices

    assert TP.factor_devices(n, axes) == factor_devices(n, axes) == dims


def test_multihost_layout_two_nodes_of_four():
    """dp spans the nodes; each sp and tp group lies in one node."""
    layout = multihost_layout(8, 4)
    assert layout.shape == (2, 2, 2)
    np.testing.assert_array_equal(layout.reshape(-1), np.arange(8))
    node = layout // 4
    assert (node == np.arange(2)[:, None, None]).all()      # dp = node
    with pytest.raises(ValueError):
        multihost_layout(8, 3)
    # The data axis placed last still spans the nodes.
    last = multihost_layout(8, 4, ('sp', 'tp', 'dp'), 'dp')
    assert (last // 4 == np.arange(2)[None, None, :]).all()


def test_single_process_mesh():
    """No process group: a (1, 1, 1) mesh without collectives, and put /
    gather hand back the global value."""
    mesh = TP.make_mesh(device_type='cpu')
    assert mesh.shape == {'dp': 1, 'sp': 1, 'tp': 1}
    assert not mesh.has_groups and mesh.device == torch.device('cpu')
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    local = TP.put(x, TP.batch_sharding(mesh, ndim=3))
    assert isinstance(local, torch.Tensor)
    np.testing.assert_array_equal(local.numpy(), x)
    np.testing.assert_array_equal(
        TP.gather(local, TP.batch_sharding(mesh, ndim=3)).numpy(), x)
    total = torch.ones(3)
    assert mesh.all_reduce_(total, ('dp', 'sp')) is total
    assert total.tolist() == [1.0, 1.0, 1.0] and not mesh.traffic
    with pytest.raises(ValueError, match='8 devices'):
        TP.make_mesh(8, device_type='cpu')


def test_halo_rows_follow_same_padding():
    assert halo_rows(16, 3, 2, 2) == (0, 1)      # stride 2, even side
    assert halo_rows(16, 3, 1, 2) == (1, 1)
    assert halo_rows(16, 1, 1, 4) == (0, 0)
    with pytest.raises(ValueError, match='stride'):
        halo_rows(5, 3, 2, 2)


# ---------------------------------------------------------------------------
# On 8 ranks.
# ---------------------------------------------------------------------------


def _global_batch(idx=0):
    return np.arange(4 * 8 * 6 * 3, dtype=np.float32).reshape(4, 8, 6, 3) + idx


def _mega_inputs():
    from vkit_tpu_torch.mechanism.distortion.photometric import (
        ColorBalanceConfig,
    )

    images = np.random.default_rng(0).integers(0, 256, (8, 32, 48, 3),
                                               dtype=np.uint8)
    return images, ColorBalanceConfig(ratio=0.5)


def _mesh_body(rank, root):
    from vkit_tpu_torch.mechanism.photometric_program import apply_mega_round

    out = {}
    mesh = TP.make_mesh(8, device_type='cpu')
    out['shape'] = dict(mesh.shape)
    out['spec'] = TP.batch_sharding(mesh).spec
    out['coords'] = tuple(mesh.coordinate(axis) for axis in mesh.axis_names)
    total = torch.tensor([float(rank), 1.0])
    mesh.all_reduce_(total, ('dp', 'sp'))
    out['dp_sp_sum'] = total.tolist()
    out['dp_sp_bytes'] = mesh.traffic['all_reduce']
    sharding = TP.batch_sharding(mesh)
    local = TP.put(_global_batch(), sharding)
    out['local'] = local
    out['gathered'] = TP.gather(local, sharding)
    out['tp_names'] = sorted(
        name for name, s in TP.shard_params_for_tp(
            TM.create_model(**FULL_WIDTH).state_dict(), mesh,
            min_channels=256).items() if 'tp' in s.spec)

    os.environ['LOCAL_WORLD_SIZE'] = '4'
    nodes = TP.make_multihost_mesh(device_type='cpu')
    out['multihost'] = (dict(nodes.shape),
                        tuple(nodes.coordinate(a) for a in nodes.axis_names))

    seen = list(TP.prefetch_map(
        lambda idx: {'images': _global_batch(idx), 'index': idx}, 3,
        sharding=sharding))
    out['prefetched'] = [
        batch['index'] == idx and torch.equal(
            batch['images'],
            torch.from_numpy(local_slice(_global_batch(idx), sharding)))
        for idx, batch in enumerate(seen)]

    flat = TP.make_mesh(8, axis_names=('dp',), device_type='cpu')
    images, config = _mega_inputs()
    mine = TP.put(images, TP.data_sharding(flat, 4))
    got = apply_mega_round(mine, {'color_balance': [(0, config)]}, 5)
    out['mega'] = TP.gather(got, TP.data_sharding(flat, 4))
    out['traffic'] = dict(mesh.traffic)
    return out


@pytest.fixture(scope='module')
def mesh_ranks(tmp_path_factory):
    return spawn(_mesh_body, 8, tmp_path_factory.mktemp('torch_mesh'))


def test_ranks_load_no_jax(mesh_ranks):
    assert [r['loaded'] for r in mesh_ranks] == [[]] * 8


def test_make_mesh_and_sharding(mesh_ranks):
    for r in mesh_ranks:
        assert r['shape'] == {'dp': 2, 'sp': 2, 'tp': 2}
        assert r['spec'][:2] == ('dp', 'sp')
    # Row-major: tp is the fastest axis, dp the slowest.
    assert [r['coords'] for r in mesh_ranks] == [
        (d, s, t) for d in range(2) for s in range(2) for t in range(2)]


def test_all_reduce_sums_over_dp_x_sp_in_one_collective(mesh_ranks):
    """The ranks of one tp coordinate (every other rank) sum together, in
    one all-reduce of the tensor's bytes."""
    for rank, r in enumerate(mesh_ranks):
        assert r['dp_sp_sum'] == [float(sum(range(rank % 2, 8, 2))), 4.0]
        assert r['dp_sp_bytes'] == 8


def test_put_and_gather_round_trip(mesh_ranks):
    x = _global_batch()
    for r in mesh_ranks:
        d, s, _ = r['coords']
        np.testing.assert_array_equal(
            r['local'].numpy(), x[2 * d:2 * d + 2, 4 * s:4 * s + 4])
        np.testing.assert_array_equal(r['gathered'].numpy(), x)
    assert mesh_ranks[0]['traffic']['all_gather'] > 0


def test_multihost_mesh_keeps_sp_and_tp_in_a_node(mesh_ranks):
    for rank, r in enumerate(mesh_ranks):
        shape, (d, s, t) = r['multihost']
        assert shape == {'dp': 2, 'sp': 2, 'tp': 2}
        assert d == rank // 4 and s * 2 + t == rank % 4


def test_shard_params_for_tp_names_match_reference(mesh_ranks):
    """The same parameters split as in vkit_tpu (cout last there, first
    here): the default widths at min_channels 256 split the last two
    stages' convs."""
    import jax
    import jax.numpy as jnp

    from vkit_tpu import models as JM
    from vkit_tpu.parallel import make_mesh, shard_params_for_tp

    model = JM.create_model(dtype=jnp.float32, **FULL_WIDTH)
    params = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3), jnp.uint8))['params']
    specs = shard_params_for_tp(params, make_mesh(8), min_channels=256)
    ref = set()
    for path, prefix, _ in convert._detector_names(4):
        leaf = specs
        for name in path:
            leaf = leaf[name]
        ref |= {f'{prefix}.{"weight" if key in ("kernel", "scale") else key}'
                for key, sharding in leaf.items() if 'tp' in sharding.spec}
    assert ref == set(mesh_ranks[0]['tp_names']) == {
        f'stages.{i}.conv{j}.weight' for i in (2, 3) for j in (1, 2)}


def test_sharded_prefetch_hands_each_rank_its_slice(mesh_ranks):
    assert [r['prefetched'] for r in mesh_ranks] == [[True] * 3] * 8


def test_dp_sharded_mega_round_matches_unsharded(mesh_ranks):
    from vkit_tpu_torch.mechanism.photometric_program import apply_mega_round

    images, config = _mega_inputs()
    want = apply_mega_round(
        torch.from_numpy(images),
        {'color_balance': [(i, config) for i in range(8)]}, 5)
    for r in mesh_ranks:
        assert torch.equal(r['mega'], want)
    assert not torch.equal(want, torch.from_numpy(images))
