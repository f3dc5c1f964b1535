"""The port's photometric stage against vkit_tpu's: the 25-name catalog
through the per-name dispatch, the one-program round, the bit-exact JPEG
roundtrip, histogram equalization and the randomized stage.  Inputs come
from a numpy seed; vkit_tpu runs on the CPU.

Deterministic ops must agree exactly, or within 1 LSB where the op ends in
a float sum; color_shift / brightness_shift round an HSV / HSL intermediate
to uint8, and are held to the bound the reference holds its own two
programs to (max 8 LSB, mean < 0.5).  The rng-consuming ops draw from
other generators in the two packages and are compared in distribution."""
import copy

import attr
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkit_tpu.mechanism.batched import (
    _COMPILED_CATALOG,
    batch_distort_images_compiled,
)
from vkit_tpu.mechanism.batched_random import _static_signature
from vkit_tpu.mechanism.batched_random import (
    batch_random_photometric_distort as jax_photometric,
)
from vkit_tpu.mechanism.distortion_policy.random_distortion import (
    random_distortion_factory,
)
from vkit_tpu.mechanism.photometric_program import (
    apply_mega_round as jax_mega_round,
)
from vkit_tpu.mechanism.photometric_program import (
    build_round_params,
    mega_covers,
)
from vkit_tpu.ops.color import equalize_hist_batch as jax_equalize
from vkit_tpu.ops.effect import (
    _CHROMA_QTABLE,
    _LUMA_QTABLE,
    _quality_scaled_table,
)
from vkit_tpu.ops.jpeg_exact import jpeg_roundtrip_exact_jnp
from vkit_tpu_torch.mechanism.batched import (
    RNG_CONSUMING,
    _prep_kernels,
    batch_distort_images,
    batch_distort_members,
)
from vkit_tpu_torch.mechanism.batched_random import (
    batch_random_photometric_distort,
    sample_photometric_sequences,
)
from vkit_tpu_torch.mechanism.photometric_program import (
    MEGA_NAMES,
    apply_mega_round,
)
from vkit_tpu_torch.ops.blur import filter2d
from vkit_tpu_torch.ops.color import equalize_hist_batch
from vkit_tpu_torch.ops.jpeg_exact import jpeg_roundtrip_exact

torch.set_num_threads(1)

STAGE = random_distortion_factory.create_photometric_stage_config()
POLICIES = {p.name: p for p in STAGE.distortion_policies}
HSV_ROUNDING = frozenset({'color_shift', 'brightness_shift'})
FLOAT_SUM = frozenset({
    'gaussian_blur', 'defocus_blur', 'motion_blur', 'std_shift',
    'pixelation', 'zoom_in_blur',
})
SHAPE = (3, 64, 80, 3)


def _images(seed, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def assert_deterministic_close(names, got, want):
    """``got`` against ``want`` at the tolerance of the ops in ``names``."""
    diff = np.abs(got.astype(int) - want.astype(int))
    if set(names) & HSV_ROUNDING:
        assert diff.max() <= 8 and diff.mean() < 0.5, (names, diff.max())
    elif set(names) & FLOAT_SUM:
        assert diff.max() <= 1, (names, diff.max())
    else:
        np.testing.assert_array_equal(got, want, err_msg=str(names))


def _noise_moments(out, img):
    delta = out.astype(np.float64) - img.astype(np.float64)
    return delta.mean(), delta.std()


def assert_same_distribution(name, got, want, images, configs):
    """Per-sample checks of an rng-consuming op's output against the
    reference's output on the same images and configs."""
    assert got.shape == want.shape and got.dtype == want.dtype
    for g, w, img, cfg in zip(got, want, images, configs):
        if name in ('gaussion_noise', 'poisson_noise', 'speckle_noise'):
            g_mean, g_std = _noise_moments(g, img)
            w_mean, w_std = _noise_moments(w, img)
            assert abs(g_mean - w_mean) <= 0.5 + 0.1 * w_std
            assert 0.85 * w_std - 0.5 <= g_std <= 1.15 * w_std + 0.5
        elif name == 'impulse_noise':
            for value, base in ((255, img < 255), (0, img > 0)):
                frac_g = np.mean((g == value) & base)
                frac_w = np.mean((w == value) & base)
                tol = 5 * np.sqrt(max(frac_w, 1e-3) / g.size) + 2e-3
                assert abs(frac_g - frac_w) <= tol, (value, frac_g, frac_w)
        elif name == 'channel_permutation':
            # Every output channel is one input channel, all distinct.
            picks = [next(i for i in range(3)
                          if np.array_equal(g[..., c], img[..., i]))
                     for c in range(3)]
            assert sorted(picks) == [0, 1, 2]
        elif name == 'fog':
            # A per-pixel blend of the image and the fog color, by a
            # field that is not constant.
            fog = np.broadcast_to(np.asarray(cfg.fog_rgb), img.shape)
            lo = np.minimum(img, fog).astype(int) - 1
            hi = np.maximum(img, fog).astype(int) + 1
            assert ((g >= lo) & (g <= hi)).all()
            far = np.abs(fog.astype(int) - img.astype(int)) > 32
            ratio = ((g.astype(float) - img)[far]
                     / (fog.astype(float) - img)[far])
            assert ratio.std() > 0.01
        else:
            raise AssertionError(f'no distribution check for {name}')


def _configs(name, rng, n=3, shape=SHAPE[1:3]):
    """Policy-sampled level-5 configs that can share one batched apply."""
    configs = [POLICIES[name].sample_config(5, shape, rng) for _ in range(n)]
    sig0 = _static_signature(name, configs[0])
    configs = [c if _static_signature(name, c) == sig0 else configs[0]
               for c in configs]
    if name in ('pixelation', 'zoom_in_blur'):
        configs = [configs[0]] * n
    return configs


@pytest.mark.parametrize('name', sorted(_COMPILED_CATALOG))
def test_catalog_matches_jax(name):
    images = _images(0)
    configs = _configs(name, np.random.default_rng(11))
    try:
        want = np.asarray(batch_distort_images_compiled(
            name, configs, jnp.asarray(images), seed=7))
    except AssertionError:
        configs = [configs[0]] * 3
        want = np.asarray(batch_distort_images_compiled(
            name, configs, jnp.asarray(images), seed=7))
    got_t = batch_distort_images(name, configs, torch.from_numpy(images),
                                 seed=7)
    assert got_t.dtype == torch.uint8
    got = got_t.numpy()
    if name not in RNG_CONSUMING:
        assert_deterministic_close([name], got, want)
        return
    if name == 'glass_blur':
        # The rolls branch: swaps only permute pixels of the blurred image.
        kernels = _prep_kernels('gaussian_blur', configs, images.shape)
        blurred = filter2d(torch.from_numpy(images), kernels).numpy()
        for g, b in zip(got, blurred):
            assert np.array_equal(np.sort(g, axis=None), np.sort(b, axis=None))
        assert not np.array_equal(got, blurred)
    else:
        assert_same_distribution(name, got, want, images, configs)
    # Non-members of a member sub-batch pass through untouched.
    group = [(0, configs[0]), (2, configs[2])]
    out = batch_distort_members(name, group, torch.from_numpy(images),
                                seed=7).numpy()
    assert np.array_equal(out[1], images[1])
    if name != 'channel_permutation':   # may draw the identity
        assert not np.array_equal(out[0], images[0])


def test_glass_blur_gather_branch_matches_jax():
    """delta > 2 takes the host-permutation branch: the permutation comes
    from the seed on both sides, so only the blur before it differs."""
    images = _images(1)
    configs = [attr.evolve(c, delta=3, loop=2)
               for c in _configs('glass_blur', np.random.default_rng(2))]
    want = np.asarray(batch_distort_images_compiled(
        'glass_blur', configs, jnp.asarray(images), seed=5))
    got = batch_distort_images('glass_blur', configs,
                               torch.from_numpy(images), seed=5).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


MEGA_SHAPE = (3, 48, 64, 3)


def _mega_pair(images, members, seed):
    sel, params = build_round_params(images.shape[0], members)
    want = np.asarray(jax_mega_round(
        jnp.asarray(images), jnp.asarray(sel),
        {k: jnp.asarray(v) for k, v in params.items()}, np.uint32(seed),
    ))
    got = apply_mega_round(torch.from_numpy(images), members, seed).numpy()
    return got, want


@pytest.mark.parametrize('name', sorted(MEGA_NAMES))
def test_mega_round_matches_jax(name):
    images = _images(0, MEGA_SHAPE)
    configs = _configs(name, np.random.default_rng(3), shape=MEGA_SHAPE[1:3])
    got, want = _mega_pair(images, {name: list(enumerate(configs))}, 11)
    if name in RNG_CONSUMING:
        assert_same_distribution(name, got, want, images, configs)
    else:
        assert_deterministic_close([name], got, want)


def test_mega_round_passthrough():
    """No draw (sel = -1 everywhere): the round is an exact identity."""
    images = _images(1, (2, 32, 32, 3))
    got, want = _mega_pair(images, {}, 0)
    np.testing.assert_array_equal(got, images)
    np.testing.assert_array_equal(want, images)


def test_mega_round_mixed():
    """Different ops per sample in one round, one sample passing through."""
    rng = np.random.default_rng(5)
    images = _images(2, (4, 40, 40, 3))
    names = ['complement', 'posterization', 'gaussian_blur']
    members = {name: [(i, POLICIES[name].sample_config(5, (40, 40), rng))]
               for i, name in enumerate(names)}
    got, want = _mega_pair(images, members, 9)
    assert_deterministic_close(names, got, want)
    np.testing.assert_array_equal(got[3], images[3])


def test_mega_round_refuses_uncovered_draw():
    """A draw the reference's one-program round does not cover belongs to
    the per-name rounds."""
    config = POLICIES['jpeg_quality'].sample_config(
        5, (32, 32), np.random.default_rng(6))
    assert not mega_covers('jpeg_quality', config)
    with pytest.raises(ValueError):
        apply_mega_round(torch.from_numpy(_images(3, (2, 32, 32, 3))),
                         {'jpeg_quality': [(0, config)]}, 0)


@pytest.mark.parametrize('shape', [(61, 77), (64, 80), (9, 3)])
def test_jpeg_roundtrip_bit_exact(shape):
    images = _images(3, (2,) + shape + (3,))
    qualities = (12, 87)
    luma = np.stack([_quality_scaled_table(_LUMA_QTABLE, q)
                     for q in qualities]).astype(np.int32)
    chroma = np.stack([_quality_scaled_table(_CHROMA_QTABLE, q)
                       for q in qualities]).astype(np.int32)
    want = np.stack([
        np.asarray(jpeg_roundtrip_exact_jnp(
            jnp.asarray(img), jnp.asarray(lq), jnp.asarray(cq)))
        for img, lq, cq in zip(images, luma, chroma)
    ])
    got = jpeg_roundtrip_exact(torch.from_numpy(images),
                               torch.from_numpy(luma),
                               torch.from_numpy(chroma)).numpy()
    np.testing.assert_array_equal(got, want)


def test_equalize_hist_matches_jax():
    planes = _images(4, (4, 37, 53))
    planes[1] = 200                      # a single-value plane: identity
    planes[2] = planes[2] // 64          # four levels only
    want = np.asarray(jax_equalize(jnp.asarray(planes)))
    got = equalize_hist_batch(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], planes[1])


def _deterministic_stage():
    keep = [i for i, p in enumerate(STAGE.distortion_policies)
            if p.name not in RNG_CONSUMING]
    return attr.evolve(
        STAGE,
        distortion_policies=[STAGE.distortion_policies[i] for i in keep],
        distortion_policy_weights=[STAGE.distortion_policy_weights[i]
                                   for i in keep],
    )


def test_random_stage_deterministic_matches_jax():
    stage = _deterministic_stage()
    images = _images(5, (6, 48, 56, 3))
    rng_ref, rng_port = (np.random.default_rng(21) for _ in range(2))
    _, sequences = sample_photometric_sequences(
        6, (48, 56), 6, copy.deepcopy(rng_port), stage)
    want = np.asarray(jax_photometric(jnp.asarray(images), 6, rng_ref,
                                      stage_config=stage))
    got = batch_random_photometric_distort(
        torch.from_numpy(images), 6, rng_port, stage_config=stage).numpy()
    assert rng_ref.random() == rng_port.random()
    assert any(sequences)
    for g, w, seq in zip(got, want, sequences):
        assert_deterministic_close([name for name, _ in seq], g, w)


def test_random_stage_default_keeps_rng_and_idle_samples():
    images = _images(6, (8, 40, 40, 3))
    rng_ref, rng_port = (np.random.default_rng(33) for _ in range(2))
    _, sequences = sample_photometric_sequences(
        8, (40, 40), 5, copy.deepcopy(rng_port))
    jax_photometric(jnp.asarray(images), 5, rng_ref)
    got = batch_random_photometric_distort(
        torch.from_numpy(images), 5, rng_port).numpy()
    assert rng_ref.random() == rng_port.random()
    assert got.shape == images.shape and got.dtype == np.uint8
    idle = [i for i, seq in enumerate(sequences) if not seq]
    assert idle and len(idle) < len(sequences)
    for i in idle:
        np.testing.assert_array_equal(got[i], images[i])


def test_batch_random_distort_matches_jax():
    """Photometric then geometric: same draws, so the same active masks,
    content boxes and rng state; images agree inside the active masks for
    samples that drew no rng-consuming op."""
    from vkit_tpu.mechanism.batched_random import (
        batch_random_distort as jax_distort,
    )
    from vkit_tpu_torch.mechanism.batched_random import batch_random_distort

    images = _images(9, (4, 48, 48, 3))
    rng_ref, rng_port = (np.random.default_rng(44) for _ in range(2))
    _, sequences = sample_photometric_sequences(
        4, (48, 48), 5, copy.deepcopy(rng_port))
    want, want_active, want_boxes = jax_distort(jnp.asarray(images), 5,
                                                rng_ref)
    got, active, boxes = batch_random_distort(torch.from_numpy(images), 5,
                                              rng_port)
    assert rng_ref.random() == rng_port.random()
    np.testing.assert_array_equal(active, want_active)
    assert [(b.up, b.down, b.left, b.right) for b in boxes] == \
        [(b.up, b.down, b.left, b.right) for b in want_boxes]
    got, want = got.numpy(), np.asarray(want)
    compared = 0
    for sample, seq in enumerate(sequences):
        names = [name for name, _ in seq]
        if set(names) & RNG_CONSUMING:
            continue
        inside = active[sample] > 0
        # The warp ends in a float sum: at least the 1-LSB bound.
        assert_deterministic_close(names + ['gaussian_blur'],
                                   got[sample][inside], want[sample][inside])
        compared += 1
    assert compared > 0


OPS_CASES = ['rgb_to_gray', 'filter2d_gray', 'blend', 'blend_masked_max']


@pytest.mark.parametrize('case', OPS_CASES)
def test_ops_match_jax(case):
    """The device ops on shapes the catalog does not give them (a single
    image, a gray plane, a scalar blend), against vkit_tpu's."""
    from vkit_tpu.ops import blend as jax_blend
    from vkit_tpu.ops import blur as jax_blur
    from vkit_tpu.ops import color as jax_color
    from vkit_tpu_torch.ops import blend as port_blend
    from vkit_tpu_torch.ops import blur as port_blur
    from vkit_tpu_torch.ops import color as port_color

    image = _images(10, (37, 45, 3))
    mask = np.random.default_rng(11).random((37, 45)) > 0.5
    calls = {
        'rgb_to_gray': lambda m, x: m[0].rgb_to_gray(x),
        'filter2d_gray': lambda m, x: m[1].filter2d(
            x[..., 0], np.arange(9, dtype=np.float32).reshape(3, 3) / 36),
        'blend': lambda m, x: m[2].blend(x, 200, alpha=0.3),
        'blend_masked_max': lambda m, x: m[2].blend(
            x, 128, np_mask=m[3](mask), alpha=0.7, keep_max_value=True),
    }
    jax_mods = (jax_color, jax_blur, jax_blend, jnp.asarray)
    port_mods = (port_color, port_blur, port_blend, torch.from_numpy)
    want = np.asarray(calls[case](jax_mods, jnp.asarray(image)))
    got = calls[case](port_mods, torch.from_numpy(image)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize('name', ['gaussian', 'poisson', 'impulse',
                                  'speckle'])
def test_noise_ops_match_jax_in_distribution(name):
    import jax

    from vkit_tpu.ops import noise as jax_noise
    from vkit_tpu_torch.ops import noise as port_noise

    image = np.full((96, 96, 3), 100, dtype=np.uint8)
    args = {'gaussian': (8.0,), 'poisson': (), 'impulse': (0.05, 0.03),
            'speckle': (0.1,)}[name]
    want = np.asarray(getattr(jax_noise, f'{name}_noise')(
        jax.random.PRNGKey(3), jnp.asarray(image), *args))
    gen = torch.Generator().manual_seed(3)
    got = getattr(port_noise, f'{name}_noise')(
        gen, torch.from_numpy(image), *args).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == 'impulse':
        for value in (255, 0):
            assert abs(np.mean(got == value) - np.mean(want == value)) < 0.02
        return
    g_mean, g_std = _noise_moments(got, image)
    w_mean, w_std = _noise_moments(want, image)
    assert abs(g_mean - w_mean) <= 0.5 and abs(g_std - w_std) <= 0.1 * w_std


CATALOG_FUNCTIONS = ['gaussian_blur', 'defocus_blur', 'motion_blur',
                     'glass_blur', 'jpeg_quality', 'line_streak',
                     'rectangle_streak', 'ellipse_streak']


@pytest.mark.parametrize('name', CATALOG_FUNCTIONS)
def test_catalog_functions_match_jax(name):
    """The catalog's public functions with per-sample parameters (the
    glass blur's permutation from the same numpy rng on both sides)."""
    from vkit_tpu.mechanism import batched as jax_batched
    from vkit_tpu_torch.mechanism import batched as port_batched

    images = _images(12)
    configs = _configs(name, np.random.default_rng(13))

    def field(key):
        return [getattr(c, key) for c in configs]

    args = {
        'gaussian_blur': lambda: (field('sigma'),),
        'defocus_blur': lambda: (field('radius'),),
        'motion_blur': lambda: (field('radius'), field('angle')),
        'glass_blur': lambda: (field('sigma'), [3, 1, 2], [2, 9, 1]),
        'jpeg_quality': lambda: (field('quality'),),
    }.get(name, lambda: (configs,))()
    extra = ((np.random.default_rng(14),), (np.random.default_rng(14),)) \
        if name == 'glass_blur' else ((), ())
    fn = f'batched_{name}'
    want = np.asarray(getattr(jax_batched, fn)(jnp.asarray(images), *args,
                                               *extra[0]))
    got = getattr(port_batched, fn)(torch.from_numpy(images), *args,
                                    *extra[1]).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= (
        1 if 'blur' in name else 0)
