"""The port's sharded training (TextDetectionNet.shard, the sharded train
step and checkpoints, entry.dryrun_multichip) against the unsharded port
and vkit_tpu's unsharded jax step, on 8 gloo ranks.

flax's initial parameters reach the ranks as an .npz of the port's
state_dict (``convert.detector_state_from_flax``), the batch as another.
Each rank runs the float32 narrow net on a (2, 2, 2) dp x sp x tp mesh
(stage_features (32, 64), so min_channels 64 splits the second stage's
convs over tp, and side 32 gives each sp rank 8 output rows) and on an
(8,) dp mesh; it saves the gathered outputs and states for the tests to
hold against the references.  As in tests/test_torch_mesh.py, jax and
vkit_tpu are imported only where the reference runs.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import spawn
from vkit_tpu_torch import convert
from vkit_tpu_torch import models as TM
from vkit_tpu_torch import parallel as TP
from vkit_tpu_torch.models.train import train_state_sharding

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(stage_features=(32, 64), fpn_features=32)
MIN_CHANNELS = 64
LR = 3e-3
N, SIDE = 8, 32


def _batch_fields(seed=0):
    """Random images and sparse random labels, different in every sample
    and row, so that each rank's slice counts."""
    rng = np.random.default_rng(seed)
    half = SIDE // 2
    masks = (rng.random((N, half, half)) < 0.2).astype(np.float32)
    return dict(
        images=rng.integers(0, 256, (N, SIDE, SIDE, 3), dtype=np.uint8),
        char_masks=masks,
        char_heights=masks * rng.uniform(4, 12, (N, half, half)).astype(
            np.float32),
        char_gaussians=masks * rng.random((N, half, half)).astype(np.float32),
    )


def _flax_params():
    import jax
    import jax.numpy as jnp

    from vkit_tpu import models as JM

    model = JM.create_model(dtype=jnp.float32, **NARROW)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 np.zeros((1, 32, 32, 3), np.uint8))['params']
    return model, jax.tree_util.tree_map(np.asarray, params)


def _load(root):
    start = {k: torch.from_numpy(v)
             for k, v in np.load(root / 'params.npz').items()}
    fields = {k: torch.from_numpy(v)
              for k, v in np.load(root / 'batch.npz').items()}
    return start, TM.TrainBatch(**fields)


def _sharded_step(mesh, start, batch, root, tag):
    """The net laid out on ``mesh``, its forward, one AdamW step and a
    checkpoint round trip; the gathered results."""
    model = TM.create_model(dtype=torch.float32, **NARROW)
    model.load_state_dict(start)
    opt = TM.create_optimizer(LR)
    state = TM.TrainState(
        params={k: v.clone() for k, v in model.state_dict().items()},
        opt_state=opt(model.parameters()).state_dict(),
        step=torch.zeros((), dtype=torch.int32))
    shardings = TP.shard_params_for_tp(state.params, mesh, MIN_CHANNELS)
    model.shard(shardings)
    state = TP.put(state, train_state_sharding(state, shardings))
    labels = TP.data_sharding(mesh, 3)
    local = TP.put(batch, TM.TrainBatch(TP.batch_sharding(mesh, 4),
                                        labels, labels, labels))
    out = {'split': sorted(name for name, s in shardings.items() if s.spec),
           'rows': int(local.images.shape[1])}
    with torch.no_grad():
        out['forward'] = [TP.gather(o, TP.batch_sharding(mesh, 4))
                          for o in model(local.images)]
    new_state, metrics = TM.make_train_step(model, opt)(state, local)
    out['metrics'] = {k: float(v) for k, v in metrics.items()}
    out['state'] = TP.gather(new_state,
                             train_state_sharding(new_state, shardings))

    manager = TM.CheckpointManager(root / f'ckpt_{tag}')
    manager.save(new_state, metadata={'mesh': tag}, sharding=shardings)
    restored = manager.restore(state, sharding=shardings)
    out['restored_equal'] = (
        int(restored.step) == 1
        and all(torch.equal(v, new_state.params[k])
                for k, v in restored.params.items())
        and all(torch.equal(v, new_state.opt_state['state'][i][key])
                for i, entry in restored.opt_state['state'].items()
                for key, v in entry.items()))
    return out


def _train_body(rank, root):
    start, batch = _load(root)
    cube = TP.make_mesh(8, device_type='cpu')
    flat = TP.make_mesh(8, axis_names=('dp',), device_type='cpu')
    return {'cube': _sharded_step(cube, start, batch, root, 'cube'),
            'flat': _sharded_step(flat, start, batch, root, 'flat')}


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """The ranks' results beside the unsharded references: vkit_tpu's jax
    step and the port's unsharded forward, from the same parameters."""
    import jax
    import jax.numpy as jnp

    from vkit_tpu import models as JM

    root = tmp_path_factory.mktemp('torch_multidevice')
    model, params = _flax_params()
    start = convert.detector_state_from_flax(params)
    np.savez(root / 'params.npz', **{k: v.numpy() for k, v in start.items()})
    fields = _batch_fields()
    np.savez(root / 'batch.npz', **fields)

    optimizer = JM.create_optimizer(LR)
    ref_state = JM.TrainState(params=params, opt_state=optimizer.init(params),
                              step=jnp.zeros((), jnp.int32))
    ref_state, ref_metrics = jax.jit(JM.make_train_step(model, optimizer))(
        ref_state, JM.TrainBatch(**fields))

    net = TM.create_model(dtype=torch.float32, **NARROW)
    net.load_state_dict(start)
    with torch.no_grad():
        forward = net(torch.from_numpy(fields['images']))
    adam = next(s for s in jax.tree_util.tree_leaves(
        ref_state.opt_state, is_leaf=lambda s: hasattr(s, 'mu'))
        if hasattr(s, 'mu'))
    return {
        'root': root,
        'ranks': spawn(_train_body, 8, root),
        'start': params,
        'params': jax.tree_util.tree_map(np.asarray, ref_state.params),
        'metrics': {k: float(v) for k, v in ref_metrics.items()},
        'forward': forward,
        # optax's first and second moments, in the port's layout.
        'exp_avg': convert.detector_state_from_flax(
            jax.tree_util.tree_map(np.asarray, adam.mu)),
        'exp_avg_sq': convert.detector_state_from_flax(
            jax.tree_util.tree_map(np.asarray, adam.nu)),
    }


def test_ranks_load_no_jax(reference):
    assert [r['loaded'] for r in reference['ranks']] == [[]] * 8


def test_sp_tp_forward_matches_unsharded(reference):
    for r in reference['ranks']:
        cube = r['cube']
        # Each rank held half the rows of its half of the batch, and tp
        # split the second stage.
        assert cube['rows'] == SIDE // 2
        assert cube['split'] == [f'stages.1.conv{j}.weight' for j in (1, 2)]
        for got, want in zip(cube['forward'], reference['forward']):
            assert got.shape == want.shape == (N, SIDE // 2, SIDE // 2, 1)
            assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize('mesh', ['flat', 'cube'])
def test_sharded_adamw_step_matches_jax(reference, mesh):
    """Parameters after one sharded AdamW step against vkit_tpu's
    unsharded step from the same flax parameters and batch: within 1e-5,
    the tolerance of test_torch_models.py's unsharded comparison."""
    import jax

    ref = jax.tree_util.tree_leaves_with_path(reference['params'])
    start = dict(jax.tree_util.tree_leaves_with_path(reference['start']))
    for r in reference['ranks']:
        got = r[mesh]
        for name, value in got['metrics'].items():
            assert math.isclose(value, reference['metrics'][name],
                                rel_tol=1e-5), name
        leaves = jax.tree_util.tree_leaves_with_path(
            convert.detector_state_to_flax(got['state'].params))
        assert [p for p, _ in leaves] == [p for p, _ in ref]
        moved = 0.0
        for (path, want), (_, have) in zip(ref, leaves):
            assert np.abs(want - have).max() <= 1e-5, path
            moved = max(moved, float(np.abs(want - start[path]).max()))
        assert moved > 1e-3                     # the step did move them
        assert int(got['state'].step) == 1


@pytest.mark.parametrize('mesh', ['flat', 'cube'])
def test_sharded_gradients_are_sums_like_jax(reference, mesh):
    """AdamW's moments after one sharded step against optax's mu and nu
    (0.1 g and 0.001 g^2 of the global gradient), each leaf within 1e-4
    of its largest value.  The parameters alone cannot show a gradient
    scaled by a constant, such as a mean over dp in place of the sum: the
    first AdamW step moves each parameter by about lr * sign(g)."""
    for r in reference['ranks']:
        state = r[mesh]['state']
        assert len(state.opt_state['state']) == len(state.params)
        for index, name in enumerate(state.params):
            for key in ('exp_avg', 'exp_avg_sq'):
                want = reference[key][name].numpy()
                have = state.opt_state['state'][index][key].numpy()
                assert have.shape == want.shape, (name, key)
                scale = float(np.abs(want).max())
                assert scale > 0 and (
                    np.abs(have - want).max() <= 1e-4 * scale), (name, key)


@pytest.mark.parametrize('mesh', ['flat', 'cube'])
def test_sharded_checkpoint_restores_equal(reference, mesh):
    """Into the same mesh (each rank its slices), and into one process:
    the file holds the gathered state in the unsharded layout."""
    assert all(r[mesh]['restored_equal'] for r in reference['ranks'])
    saved = reference['ranks'][0][mesh]['state']
    model = TM.create_model(dtype=torch.float32, **NARROW)
    example = TM.init_train_state(model, TM.create_optimizer(LR), None,
                                  device='cpu')
    manager = TM.CheckpointManager(reference['root'] / f'ckpt_{mesh}')
    restored = manager.restore(example)
    assert manager.read_metadata() == {'step': 1, 'mesh': mesh}
    assert int(restored.step) == 1
    for name, value in saved.params.items():
        assert torch.equal(restored.params[name], value), name
    moments = saved.opt_state['state']
    assert len(moments) == len(saved.params)
    for index, entry in restored.opt_state['state'].items():
        for key, value in entry.items():
            assert torch.equal(value, moments[index][key]), (index, key)
    # The restored state trains on in a single process.
    step = TM.make_train_step(model, TM.create_optimizer(LR))
    fields = _batch_fields()
    state, metrics = step(restored, TM.TrainBatch(
        **{k: torch.from_numpy(v) for k, v in fields.items()}))
    assert int(state.step) == 2 and math.isfinite(float(metrics['loss']))


def _dryrun(*args):
    """``python -m vkit_tpu_torch.entry --device cpu *args``: its last two
    lines, the sharded forward's difference and the report."""
    env = {k: v for k, v in os.environ.items() if k != 'JAX_PLATFORMS'}
    proc = subprocess.run(
        [sys.executable, '-m', 'vkit_tpu_torch.entry', '--device', 'cpu',
         *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    forward, line = proc.stdout.strip().splitlines()[-2:]
    match = re.match(r'sharded forward vs the unsharded net: max abs '
                     r'difference (\S+) \(limit (\S+):', forward)
    assert match, forward
    assert float(match[1]) <= float(match[2]) < 0.5
    return line


def test_dryrun_multichip_on_8_cpu_ranks():
    """``python -m vkit_tpu_torch.entry --devices 8 --device cpu``: the
    (2, 2, 2) mesh, finite losses, labels, and the checkpoint round
    trip."""
    line = _dryrun('--devices', '8')
    match = re.fullmatch(
        r"dryrun_multichip OK: mesh=\{'dp': 2, 'sp': 2, 'tp': 2\} "
        r'processes=8 batch=4x64x64 loss=(\S+) '
        r'gen\+train\(composed 320\^2 prep pages\) loss=(\S+) '
        r'label_px=(\d+) sharded-ckpt=ok', line)
    assert match, line
    assert math.isfinite(float(match[1])) and math.isfinite(float(match[2]))
    assert int(match[3]) > 0


def test_dryrun_multichip_on_an_sp_x_tp_mesh():
    """``--axes sp,tp`` on 4 ranks: every rank holds both pages, half of
    their rows and half of the wide convs' channels."""
    line = _dryrun('--devices', '4', '--axes', 'sp,tp')
    assert re.fullmatch(
        r"dryrun_multichip OK: mesh=\{'sp': 2, 'tp': 2\} processes=4 "
        r'batch=2x64x64 loss=\S+ gen\+train\(composed 320\^2 prep pages\) '
        r'loss=\S+ label_px=[1-9]\d* sharded-ckpt=ok', line), line


def test_entry_forward_step():
    """``entry()``: the default bfloat16 net's forward and its arguments,
    on the card unless the caller asks for the CPU."""
    from vkit_tpu_torch.entry import entry

    fn, (params, images) = entry(device='cpu')
    assert tuple(images.shape) == (4, 128, 128, 3)
    assert images.dtype == torch.uint8
    outputs = fn(params, images)
    assert [tuple(o.shape) for o in outputs] == [(4, 64, 64, 1)] * 3
    assert all(o.dtype == torch.float32 and bool(torch.isfinite(o).all())
               for o in outputs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            entry()
