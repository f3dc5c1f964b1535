"""The port's training path (vkit_tpu_torch/models) against vkit_tpu's on
the same inputs and the same parameters, carried across by
``convert.detector_state_from_flax``: the detector's forward, the loss,
AdamW steps, the label bridge, evaluation, checkpoints, and the slice as a
whole (stream -> bridge -> two train steps in both packages from one
seed)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.pipeline.fixtures import build_assets
from tests.test_torch_host import planner_pair
from vkit_tpu import models as JM
from vkit_tpu.synth import (
    synthesize_page_batch as jax_synthesize_page_batch,
)
from vkit_tpu_torch import convert
from vkit_tpu_torch import models as TM
from vkit_tpu_torch.models.text_detection import _same_padding
from vkit_tpu_torch.synth import synthesize_page_batch
from vkit_tpu_torch.utility import StepTimer

torch.set_num_threads(1)

NARROW = dict(stage_features=(32, 64), fpn_features=32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _flax_params(seed, widths):
    """flax's initial parameters (float32 whatever the compute dtype; the
    example image's size decides nothing), one init per net."""
    model = JM.create_model(dtype=jnp.float32, **dict(widths))
    return model.init(jax.random.PRNGKey(seed),
                      np.zeros((1, 32, 32, 3), np.uint8))['params']


def _flax_net(dtype=jnp.float32, seed=0, **widths):
    model = JM.create_model(dtype=dtype, **widths)
    return model, _flax_params(seed, tuple(sorted(widths.items())))


def _torch_net(params, dtype=torch.float32, **widths):
    model = TM.create_model(dtype=dtype, **widths)
    model.load_state_dict(convert.detector_state_from_flax(
        _numpy_tree(params)))
    return model


def _images(case, seed=0, n=2, side=64):
    if case == 'random':
        return np.random.default_rng(seed).integers(
            0, 256, (n, side, side, 3), dtype=np.uint8)
    # Zero but for the last row and column: a stride-2 conv padded (1, 1)
    # where 'SAME' pads (0, 1) reads another pixel there.
    images = np.zeros((n, side, side, 3), dtype=np.uint8)
    images[:, -1] = 255
    images[:, :, -1] = 200
    return images


def _train_batch(n=2, side=32, seed=0):
    """The batch of tests/models/test_text_detection_model.py, with a
    graded gaussian target."""
    rng = np.random.default_rng(seed)
    half = side // 2
    images = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    masks = np.zeros((n, half, half), dtype=np.float32)
    masks[:, 4:12, 4:12] = 1.0
    heights = masks * 8.0
    gaussians = masks * rng.random((n, half, half)).astype(np.float32)
    return dict(images=images, char_masks=masks, char_heights=heights,
                char_gaussians=gaussians)


def _to_torch_batch(fields):
    return TM.TrainBatch(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in fields.items()})


# ---------------------------------------------------------------------------
# The detector.
# ---------------------------------------------------------------------------


def test_same_padding_rule():
    assert _same_padding(64, 3, 2) == (0, 1)
    assert _same_padding(63, 3, 2) == (1, 1)
    assert _same_padding(64, 3, 1) == (1, 1)
    assert _same_padding(64, 1, 1) == (0, 0)


@pytest.mark.parametrize('case', ['random', 'last_row_and_column'])
def test_forward_matches_flax_float32(case):
    images = _images(case)
    model, params = _flax_net(**NARROW)
    ref = model.apply({'params': params}, images)
    net = _torch_net(params, **NARROW)
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    assert len(got) == 3
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32
        assert tuple(b.shape) == a.shape == (2, 32, 32, 1)
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-4


def test_padding_case_tells_the_two_paddings_apart():
    """The last-row-and-column image is one that a (1, 1)-padded stride-2
    conv gets wrong by far more than the tolerance."""
    images = _images('last_row_and_column')
    _, params = _flax_net(**NARROW)
    net = _torch_net(params, **NARROW)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    conv = net.stages[0].conv1
    right = conv(x)
    wrong = torch.nn.functional.conv2d(x, conv.weight, stride=2, padding=1)
    assert right.shape == wrong.shape
    assert (right - wrong).abs().max() > 0.1


def test_forward_matches_flax_bfloat16():
    images = _images('random', seed=1)
    model, params = _flax_net(dtype=jnp.bfloat16, **NARROW)
    ref = model.apply({'params': params}, images)
    net = _torch_net(params, dtype=torch.bfloat16, **NARROW)
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32
        d = np.abs(np.asarray(a, dtype=np.float32) - b.numpy())
        assert d.max() <= 5e-2 and d.mean() <= 1e-2


def test_forward_matches_flax_full_width():
    images = _images('random', seed=2, n=1)
    model, params = _flax_net()       # 64-128-256-512, FPN 128
    assert model.stage_features == (64, 128, 256, 512)
    ref = model.apply({'params': params}, images)
    net = _torch_net(params)
    assert net.stage_features == (64, 128, 256, 512)
    assert net.fpn_features == 128 and net.dtype == torch.float32
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    for a, b in zip(ref, got):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-4


def test_defaults_are_the_published_widths_in_bfloat16():
    net = TM.create_model()
    assert net.stage_features == (64, 128, 256, 512)
    assert net.fpn_features == 128 and net.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        out = net(torch.zeros((1, 32, 32, 3), dtype=torch.uint8))
    assert [tuple(o.shape) for o in out] == [(1, 16, 16, 1)] * 3
    assert all(o.dtype == torch.float32 for o in out)


def test_weights_round_trip_through_the_flax_layout():
    images = _images('random', n=1, side=32)
    _, params = _flax_net()
    params = _numpy_tree(params)
    state = convert.detector_state_from_flax(params)
    assert set(state) == set(TM.create_model().state_dict())
    back = convert.detector_state_to_flax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        convert.detector_state_from_flax({'Conv_0': params['Conv_0']})


def test_init_draws_the_flax_distributions():
    model = TM.create_model(**NARROW)
    state = TM.init_train_state(model, TM.create_optimizer(),
                                np.zeros((1, 32, 32, 3), np.uint8), seed=3,
                                device='cpu')
    again = TM.init_train_state(TM.create_model(**NARROW),
                                TM.create_optimizer(),
                                np.zeros((1, 32, 32, 3), np.uint8), seed=3,
                                device='cpu')
    for name, value in state.params.items():
        assert torch.equal(value, again.params[name])
        if name.endswith('.bias'):
            assert not value.any()
        elif '.norm' in name:
            assert (value == 1).all()
    kernel = state.params['stages.1.conv2.weight']      # fan_in 64 * 9
    fan_in = kernel.shape[1] * 9
    assert abs(float(kernel.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(kernel.abs().max()) <= 2 / 0.87962566 / np.sqrt(fan_in) + 1e-6
    assert int(state.step) == 0 and state.opt_state['state'] == {}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device exists')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TM.init_train_state(TM.create_model(**NARROW), TM.create_optimizer(),
                            np.zeros((1, 32, 32, 3), np.uint8))


# ---------------------------------------------------------------------------
# Loss and train steps.
# ---------------------------------------------------------------------------


def test_loss_terms_match_optax():
    fields = _train_batch()
    model, params = _flax_net(**NARROW)
    _, ref = JM.loss_fn(model, params, JM.TrainBatch(**fields))
    net = _torch_net(params, **NARROW)
    with torch.no_grad():
        total, got = TM.loss_fn(net, net.state_dict(),
                                _to_torch_batch(fields))
    assert set(got) == set(ref) == {'loss', 'mask_loss', 'height_loss',
                                    'gaussian_loss'}
    assert float(total) == float(got['loss'])
    for name in ref:
        np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize('steps', [1, 3])
def test_train_steps_match_optax_adamw(steps):
    """Parameters after AdamW steps from the same start: within 1e-5, which
    pins the decoupled decay (every leaf, lr * wd * p) and eps outside the
    root."""
    fields = _train_batch()
    model, params = _flax_net(**NARROW)
    optimizer = JM.create_optimizer(3e-3)
    ref_state = JM.TrainState(params=params,
                              opt_state=optimizer.init(params),
                              step=jnp.zeros((), jnp.int32))
    ref_step = jax.jit(JM.make_train_step(model, optimizer))

    net = _torch_net(params, **NARROW)
    opt = TM.create_optimizer(3e-3)
    state = TM.TrainState(
        params={k: v.clone() for k, v in net.state_dict().items()},
        opt_state=opt(net.parameters()).state_dict(),
        step=torch.zeros((), dtype=torch.int32))
    step_fn = TM.make_train_step(net, opt)
    batch = _to_torch_batch(fields)
    for _ in range(steps):
        ref_state, ref_metrics = ref_step(ref_state, JM.TrainBatch(**fields))
        state, metrics = step_fn(state, batch)
    assert int(state.step) == int(ref_state.step) == steps
    np.testing.assert_allclose(float(metrics['loss']),
                               float(ref_metrics['loss']), rtol=1e-4)
    ref_leaves = jax.tree_util.tree_leaves_with_path(
        _numpy_tree(ref_state.params))
    got_leaves = jax.tree_util.tree_leaves_with_path(
        convert.detector_state_to_flax(state.params))
    assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
    moved = 0.0
    start = dict(jax.tree_util.tree_leaves_with_path(_numpy_tree(params)))
    for (path, a), (_, b) in zip(ref_leaves, got_leaves):
        assert np.abs(a - b).max() <= 1e-5, path
        moved = max(moved, float(np.abs(a - start[path]).max()))
    assert moved > 1e-3                     # the steps did move them


def test_train_step_reduces_loss():
    """The port's twin of tests/models/test_text_detection_model.py::
    test_train_step_reduces_loss."""
    model = TM.create_model(**NARROW)
    optimizer = TM.create_optimizer(learning_rate=3e-3)
    fields = _train_batch()
    fields['char_gaussians'] = fields['char_masks'] * 0.8
    batch = _to_torch_batch(fields)
    state = TM.init_train_state(model, optimizer, batch.images[:1],
                                device='cpu')
    train_step = TM.make_train_step(model, optimizer)
    state, metrics0 = train_step(state, batch)
    for _ in range(5):
        state, metrics = train_step(state, batch)
    assert np.isfinite(float(metrics['loss']))
    assert float(metrics['loss']) < float(metrics0['loss'])
    assert int(state.step) == 6


def test_train_step_leaves_its_input_state_alone():
    model = TM.create_model(**NARROW)
    optimizer = TM.create_optimizer()
    batch = _to_torch_batch(_train_batch())
    state = TM.init_train_state(model, optimizer, batch.images[:1],
                                device='cpu')
    step_fn = TM.make_train_step(model, optimizer)
    state, _ = step_fn(state, batch)
    kept = {k: v.clone() for k, v in state.params.items()}
    moments = {k: {n: v.clone() for n, v in e.items()}
               for k, e in state.opt_state['state'].items()}
    a, _ = step_fn(state, batch)
    b, _ = step_fn(state, batch)            # the same state again
    for name, value in state.params.items():
        assert torch.equal(value, kept[name])
        assert torch.equal(a.params[name], b.params[name])
        assert not torch.equal(a.params[name], value) or not value.any()
    for key, entry in state.opt_state['state'].items():
        for name, value in entry.items():
            assert torch.equal(value, moments[key][name])
    assert int(state.step) == 1 and int(a.step) == int(b.step) == 2


# ---------------------------------------------------------------------------
# The label bridge and evaluation.
# ---------------------------------------------------------------------------


def _synth_like(seed=0, n=2, side=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    stack = np.zeros((n, side, side, 4), dtype=np.float32)
    blobs = rng.random((n, side, side)) > 0.93
    from scipy.ndimage import binary_dilation
    blobs = np.stack([binary_dilation(b, iterations=2) for b in blobs])
    stack[..., 0] = rng.random((n, side, side))
    stack[..., 1] = blobs
    stack[..., 2] = blobs * rng.uniform(6, 20, (n, side, side))
    stack[..., 3] = rng.random((n, side, side))
    active = np.ones((n, side, side), dtype=np.uint8)
    active[:, :5] = 0
    active[0, :, -7:] = 0
    gaussians = (rng.random((n, side, side)) * blobs).astype(np.float32)
    return images, stack, active, gaussians


@pytest.mark.parametrize('with_gaussians', [False, True])
def test_synth_to_train_batch_matches_jax(with_gaussians):
    images, stack, active, gaussians = _synth_like()
    extra = gaussians if with_gaussians else None
    ref = JM.synth_to_train_batch(
        jnp.asarray(images), jnp.asarray(stack), jnp.asarray(active),
        char_gaussians=None if extra is None else jnp.asarray(extra))
    got = TM.synth_to_train_batch(
        torch.from_numpy(images), torch.from_numpy(stack),
        torch.from_numpy(active),
        char_gaussians=None if extra is None else torch.from_numpy(extra))
    assert isinstance(got, TM.TrainBatch)
    assert got.char_masks.sum() > 0
    for name in TM.TrainBatch._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.abs(a.astype(np.float64) - b).max() <= 1e-6, name


def test_evaluate_matches_jax():
    model, params = _flax_net(**NARROW)
    net = _torch_net(params, **NARROW)
    batches = [_train_batch(seed=s) for s in (0, 1)]
    ref = JM.evaluate(model, params, [JM.TrainBatch(**b) for b in batches])
    got = TM.evaluate(net, net.state_dict(),
                      [_to_torch_batch(b) for b in batches])
    assert set(got) == set(ref)
    for name in ref:
        assert abs(got[name] - ref[name]) <= 1e-5, name
    assert TM.evaluate(net, net.state_dict(), [])['char_mask_iou'] == 0.0


# ---------------------------------------------------------------------------
# Checkpoints (the port's twins of tests/models/test_checkpoint.py).
# ---------------------------------------------------------------------------


def _setup():
    model = TM.create_model(**NARROW)
    optimizer = TM.create_optimizer()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    batch = _to_torch_batch(dict(
        images=images,
        char_masks=np.zeros((2, 16, 16), dtype=np.float32),
        char_heights=np.zeros((2, 16, 16), dtype=np.float32),
        char_gaussians=np.zeros((2, 16, 16), dtype=np.float32),
    ))
    state = TM.init_train_state(model, optimizer, images[:1], device='cpu')
    return model, optimizer, state, batch


def _leaves(state):
    out = dict(state.params)
    for key, entry in state.opt_state['state'].items():
        for name, value in entry.items():
            out[f'opt.{key}.{name}'] = value
    out['step'] = state.step
    return out


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert torch.equal(la[name], lb[name]), name
    assert a.opt_state['param_groups'] == b.opt_state['param_groups']


def test_checkpoint_roundtrip(tmp_path):
    model, optimizer, state, batch = _setup()
    step_fn = TM.make_train_step(model, optimizer)
    state, _ = step_fn(state, batch)

    manager = TM.CheckpointManager(tmp_path, max_to_keep=2)
    manager.save(state, metadata={'samples_seen': 2})

    restored = manager.restore(state)
    _assert_same_state(state, restored)
    assert manager.read_metadata()['samples_seen'] == 2
    assert manager.read_metadata()['step'] == 1

    # Resume continues bit-exact vs an uninterrupted run.
    cont_a, _ = step_fn(state, batch)
    cont_b, _ = step_fn(restored, batch)
    _assert_same_state(cont_a, cont_b)
    assert not list(tmp_path.glob('*.tmp'))


def test_checkpoint_retention(tmp_path):
    model, optimizer, state, batch = _setup()
    step_fn = TM.make_train_step(model, optimizer)
    manager = TM.CheckpointManager(tmp_path, max_to_keep=2)
    for _ in range(4):
        state, _ = step_fn(state, batch)
        manager.save(state)
    assert manager.all_steps() == [3, 4]
    assert manager.latest_step() == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'step_00000003', 'step_00000004']


def test_checkpoint_ignores_a_crashed_save(tmp_path):
    model, optimizer, state, batch = _setup()
    manager = TM.CheckpointManager(tmp_path)
    assert manager.latest_step() is None
    with pytest.raises(FileNotFoundError):
        manager.restore(state)
    manager.save(state)
    crashed = tmp_path / 'step_00000007.tmp'
    crashed.mkdir()
    (crashed / 'state.pt').write_bytes(b'half written')
    assert manager.all_steps() == [0] and manager.latest_step() == 0
    _assert_same_state(state, manager.restore(state))
    other = TM.init_train_state(TM.create_model(stage_features=(32,),
                                                fpn_features=32),
                                TM.create_optimizer(),
                                np.zeros((1, 32, 32, 3), np.uint8),
                                device='cpu')
    with pytest.raises(ValueError):
        manager.restore(other)


def test_step_timer():
    timer = StepTimer()
    with timer.measure('a'):
        pass
    with timer.measure('a'):
        pass
    with timer.measure('b'):
        pass
    summary = timer.summary()
    assert summary['a']['count'] == 2 and summary['b']['count'] == 1
    timer.reset()
    assert not timer.summary()


# ---------------------------------------------------------------------------
# The slice as a whole.
# ---------------------------------------------------------------------------


def test_stream_to_train_steps_matches_jax(tmp_path):
    """Two batches as ``synthesize_stream`` makes them (128 px, batch 2,
    char gaussians) through the bridge and two train steps of the narrow
    net, in both packages from one seed and the same initial parameters:
    each step's loss within 1e-3 relative (float32).  The stream has no
    switch for its photometric stage, whose rng-consuming ops match only in
    distribution, so its per-batch child seeds are replayed here through
    ``prepare_batch`` and ``synthesize_page_batch`` with that stage off."""
    assets = build_assets(tmp_path / 'assets')
    jax_planner, planner = planner_pair(assets, False, side=128)
    rng = np.random.default_rng(7)
    seeds = [int(rng.integers(0, 2**63 - 1)) for _ in range(2)]
    ref_results, results = [], []
    for seed in seeds:
        ref_rng, got_rng = (np.random.default_rng(seed) for _ in range(2))
        kwargs = dict(enable_photometric=False, emit_char_gaussians=True)
        ref_results.append(jax_synthesize_page_batch(
            jax_planner.prepare_batch(2, ref_rng), 3, ref_rng, **kwargs))
        results.append(synthesize_page_batch(
            planner.prepare_batch(2, got_rng), 3, got_rng,
            keep_on_device=True, device='cpu', **kwargs))

    model, params = _flax_net(**NARROW)
    optimizer = JM.create_optimizer(1e-3)
    ref_state = JM.TrainState(params=params,
                              opt_state=optimizer.init(params),
                              step=jnp.zeros((), jnp.int32))
    ref_step = jax.jit(JM.make_train_step(model, optimizer))
    net = _torch_net(params, **NARROW)
    opt = TM.create_optimizer(1e-3)
    state = TM.TrainState(
        params={k: v.clone() for k, v in net.state_dict().items()},
        opt_state=opt(net.parameters()).state_dict(),
        step=torch.zeros((), dtype=torch.int32))
    step_fn = TM.make_train_step(net, opt)

    text_pixels = 0
    for ref_result, result in zip(ref_results, results):
        ref_batch = JM.synth_to_train_batch(
            jnp.asarray(ref_result.images),
            jnp.asarray(ref_result.label_stack),
            jnp.asarray(ref_result.active_masks),
            char_gaussians=jnp.asarray(ref_result.char_gaussian_maps))
        batch = TM.synth_to_train_batch(
            result.images, result.label_stack, result.active_masks,
            char_gaussians=result.char_gaussian_maps)
        assert batch.images.shape == (2, 128, 128, 3)
        text_pixels += float(batch.char_masks.sum())
        ref_state, ref_metrics = ref_step(ref_state, ref_batch)
        state, metrics = step_fn(state, batch)
        for name in ('loss', 'mask_loss', 'height_loss', 'gaussian_loss'):
            assert np.isfinite(float(metrics[name]))
        np.testing.assert_allclose(float(metrics['loss']),
                                   float(ref_metrics['loss']), rtol=1e-3)
    assert text_pixels > 0 and int(state.step) == 2
