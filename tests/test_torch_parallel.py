"""The port's parallel layer (vkit_tpu_torch/parallel: the one-program
distortion chain and the prefetch pump) against vkit_tpu's on the same
inputs from the same seed.  vkit_tpu's Pallas kernels run in interpret
mode here, the port's wrappers run their plain versions."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import assert_same_value
from vkit_tpu import parallel as JP
from vkit_tpu_torch import convert
from vkit_tpu_torch import parallel as TP

torch.set_num_threads(1)


def _generator(seed=0):
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


def _params_pair(seed, n, h, w, level=5):
    ref_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = JP.sample_synthesis_params(ref_rng, n, h, w, level=level)
    got = TP.sample_synthesis_params(rng, n, h, w, level=level)
    assert ref_rng.bit_generator.state == rng.bit_generator.state
    return ref, got


def _smooth_batch(seed, n, h, w):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return np.stack([
        gaussian_filter(rng.random((h, w, 3)) * 255, sigma=(2, 2, 0))
        for _ in range(n)
    ]).astype(np.uint8)


def test_exports():
    """The reference's names, and the mesh's own types and its put /
    gather (the dry run's make_array_from_callback, and its inverse)."""
    assert set(JP.__all__) <= set(TP.__all__)
    assert set(TP.__all__) - set(JP.__all__) == {'Mesh', 'Sharding', 'put',
                                                 'gather'}


@pytest.mark.parametrize('level', [3, 5, 10])
def test_sample_synthesis_params_equal_reference(level):
    (ref, ref_statics), (got, statics) = _params_pair(level, 4, 64, 96, level)
    assert_same_value(tuple(ref_statics), tuple(statics), 'statics')
    for name in TP.SynthesisParams._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if name == 'warp_plan':
            for pass_name in ('pass_v', 'pass_h'):
                assert_same_value(
                    [np.asarray(v) for v in getattr(a, pass_name)],
                    [np.asarray(v) for v in getattr(b, pass_name)],
                    pass_name)
            continue
        assert isinstance(b, np.ndarray), name
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize('out_shape', [None, (48, 80)])
def test_synthesize_batch_matches_jax_without_noise(out_shape):
    """Noise off, JPEG on for some samples: within 1 LSB of vkit_tpu.  The
    JPEG roundtrip is bit-exact in both, so a pixel differs only where the
    warp's float32 value lies on a ``round_u8`` tie (or, through JPEG, in
    the 8 x 8 block of such a pixel); the mean stays far below that."""
    n, h, w = 4, 64, 96
    (ref_params, ref_statics), (params, statics) = _params_pair(1, n, h, w)
    assert 0 < np.asarray(params.jpeg_enables).sum() < n
    images = _smooth_batch(2, n, h, w)
    ref = np.asarray(JP.synthesize_batch(
        jnp.asarray(images),
        ref_params._replace(noise_stds=jnp.zeros(n)),
        jax.random.PRNGKey(0), warp_statics=ref_statics,
        out_shape=out_shape))
    got = TP.synthesize_batch(
        torch.from_numpy(images),
        params._replace(noise_stds=np.zeros(n, np.float32)),
        _generator(), statics, out_shape=out_shape)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == ref.shape == (n,) + (out_shape or (h, w)) + (3,)
    d = np.abs(ref.astype(int) - got.numpy().astype(int))
    plain = np.asarray(params.jpeg_enables) < 0.5
    assert d[plain].max() <= 1
    assert d.max() <= 1 and d.mean() <= 1e-3


def test_synthesize_batch_noise_in_distribution():
    """With noise on, the difference from the noise-free output has each
    sample's own std (within 10%; JPEG off and mid-grey images, so neither
    quantisation nor clipping shapes it), as the reference's has."""
    n, h, w = 4, 64, 64
    (ref_params, ref_statics), (params, statics) = _params_pair(3, n, h, w)
    stds = np.asarray([4.0, 8.0, 12.0, 16.0], np.float32)
    flat = dict(contrasts=np.ones(n, np.float32),
                brightnesses=np.zeros(n, np.float32),
                jpeg_enables=np.zeros(n, np.float32))
    images = np.full((n, h, w, 3), 128, np.uint8)

    def measured(run, to_params, zeros):
        quiet = run(to_params(noise_stds=zeros, **flat))
        noisy = run(to_params(noise_stds=stds, **flat))
        inside = quiet == 128               # not the warp's border
        return np.asarray([
            (noisy[i].astype(float) - quiet[i])[inside[i]].std()
            for i in range(n)])

    ref = measured(
        lambda p: np.asarray(JP.synthesize_batch(
            jnp.asarray(images), p, jax.random.PRNGKey(1),
            warp_statics=ref_statics)),
        lambda **f: ref_params._replace(
            **{k: jnp.asarray(v) for k, v in f.items()}),
        np.zeros(n, np.float32))
    got = measured(
        lambda p: TP.synthesize_batch(
            torch.from_numpy(images), p, _generator(1), statics).numpy(),
        lambda **f: params._replace(**f), np.zeros(n, np.float32))
    np.testing.assert_allclose(got, stds, rtol=0.1)
    np.testing.assert_allclose(got, ref, rtol=0.1)


def test_synthesize_batch_deterministic():
    """The port's twin of tests/parallel/test_parallel.py::
    test_synthesize_batch_deterministic, and of test_synthesize_batch_small:
    one generator seed, one output; params moved ahead of time change
    nothing."""
    rng = np.random.default_rng(7)
    n, h, w = 2, 64, 64
    images = torch.from_numpy(
        rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    params, statics = TP.sample_synthesis_params(rng, n, h, w)
    out1 = TP.synthesize_batch(images, params, _generator(3), statics)
    out2 = TP.synthesize_batch(images, params, _generator(3), statics)
    moved = TP.synthesize_batch(
        images, convert.synthesis_params(params, 'cpu'), _generator(3),
        statics)
    other = TP.synthesize_batch(images, params, _generator(4), statics)
    assert torch.equal(out1, out2) and torch.equal(out1, moved)
    assert not torch.equal(out1, other)
    assert out1.shape == (n, h, w, 3) and out1.dtype == torch.uint8
    assert not torch.equal(out1[0], images[0])
    assert not torch.equal(out1[0], out1[1])


def test_transform_label_points_equal_reference():
    (ref, _), (got, _) = _params_pair(3, 2, 96, 96, level=4)
    points = np.random.default_rng(0).uniform(0, 95, (2, 5, 2))
    a = JP.transform_label_points(ref, points, out_scale=(0.5, 0.75))
    b = TP.transform_label_points(got, points, out_scale=(0.5, 0.75))
    np.testing.assert_array_equal(a, b)


def test_transform_label_points_matches_warp():
    """The port's twin of tests/parallel/test_parallel.py::
    test_transform_label_points_matches_warp."""
    rng = np.random.default_rng(3)
    n, h, w = 2, 96, 96
    images = np.zeros((n, h, w, 3), dtype=np.uint8)
    p_src = np.array([[30.0, 40.0], [64.0, 20.0]])  # xy per sample
    for i, (x, y) in enumerate(p_src):
        images[i, int(y) - 1:int(y) + 2, int(x) - 1:int(x) + 2] = 255
    params, statics = TP.sample_synthesis_params(rng, n, h, w, level=4)
    params = params._replace(
        contrasts=np.ones(n, np.float32), brightnesses=np.zeros(n, np.float32),
        noise_stds=np.zeros(n, np.float32),
        jpeg_enables=np.zeros(n, np.float32))
    out = TP.synthesize_batch(torch.from_numpy(images), params, _generator(),
                              statics).numpy()
    predicted = TP.transform_label_points(params, p_src[:, None, :])[:, 0]
    for i in range(n):
        px, py = predicted[i]
        assert 2 <= px < w - 2 and 2 <= py < h - 2
        patch = out[i, int(py) - 3:int(py) + 4, int(px) - 3:int(px) + 4]
        assert patch.max() > 100  # the dot landed where predicted


def test_resize_matches_jax():
    from vkit_tpu.ops.resize import resize as jax_resize
    from vkit_tpu_torch.ops.resize import resize

    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    ref = np.asarray(jax_resize(jnp.asarray(batch), (64, 48)))
    got = resize(torch.from_numpy(batch), (64, 48))
    assert got.dtype == torch.uint8
    assert np.abs(ref.astype(int) - got.numpy().astype(int)).max() <= 1
    plane = rng.random((40, 56)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(plane), (20, 28)))
    got = resize(torch.from_numpy(plane), (20, 28))
    assert tuple(got.shape) == (20, 28)
    assert np.abs(ref - got.numpy()).max() <= 1e-5


# ---------------------------------------------------------------------------
# The prefetch pump.
# ---------------------------------------------------------------------------


def test_prefetcher_keeps_order_and_types():
    batches = [
        {'x': np.full((4, 8), idx, dtype=np.float32),
         'pair': (torch.full((2,), idx), [idx])}
        for idx in range(5)
    ]
    seen = list(TP.DevicePrefetcher(iter(batches), device='cpu', depth=2))
    assert [float(b['x'][0, 0]) for b in seen] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert all(isinstance(b['x'], torch.Tensor) for b in seen)
    assert all(b['x'].dtype == torch.float32 for b in seen)
    assert [int(b['pair'][0][0]) for b in seen] == [0, 1, 2, 3, 4]
    assert [b['pair'][1] for b in seen] == [[i] for i in range(5)]


def test_prefetch_map_and_namedtuples():
    from vkit_tpu_torch.models import TrainBatch

    def produce(idx):
        return TrainBatch(*(np.full((1, 2), idx + k, np.float32)
                            for k in range(4)))

    seen = list(TP.prefetch_map(produce, 3, device='cpu'))
    assert all(isinstance(b, TrainBatch) for b in seen)
    assert [float(b.char_heights[0, 0]) for b in seen] == [2.0, 3.0, 4.0]


def test_prefetcher_propagates_errors():
    def gen():
        yield np.zeros((2,))
        raise ValueError('boom')

    pf = TP.DevicePrefetcher(gen(), device='cpu')
    next(pf)
    with pytest.raises(ValueError, match='boom'):
        next(pf)


def test_prefetcher_stop_ends_the_pump():
    produced = []

    def gen():
        for idx in range(1000):
            produced.append(idx)
            yield np.zeros((2,))

    pf = TP.DevicePrefetcher(gen(), device='cpu', depth=1)
    next(pf)
    pf.stop()
    deadline = time.monotonic() + 10
    while pf.thread.is_alive() and time.monotonic() < deadline:
        pf.stop()                       # drain what the pump put meanwhile
        pf.thread.join(timeout=0.05)
    assert not pf.thread.is_alive()
    assert len(produced) < 1000


def test_prefetcher_needs_a_device_that_exists():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device exists')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TP.DevicePrefetcher(iter([]))
    # A sharded prefetch lands on its mesh's device, the card by default.
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TP.make_mesh()
