"""The port's dense two-pass warp (vkit_tpu_torch/ops/warp_mxu.py,
``batched_plan_warp(mode='dense')``) against vkit_tpu on the same inputs:
the host plans equal field by field, the warps within a stated tolerance.
vkit_tpu's Pallas kernels run in interpret mode here, the port's wrappers
run their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import assert_same_value
from tests.test_torch_warp import _active_diff, _plan_pair
from vkit_tpu.mechanism import batched as JB
from vkit_tpu.ops import warp_mxu as JWM
from vkit_tpu.ops.warp import remap_np
from vkit_tpu_torch import convert
from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.ops import warp_mxu as TWM

torch.set_num_threads(1)

H, W = 96, 128


@pytest.fixture(scope='module')
def smooth_image():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    return gaussian_filter(
        rng.random((H, W, 3)) * 255, sigma=2
    ).astype(np.float32)


def _fields(kind):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    if kind == 'separable':
        fields = [
            (ys, xs),
            (ys + 7.0 * np.sin(2 * np.pi * xs / W), xs),
            (ys, xs + 4.0 * np.sin(2 * np.pi * ys / H)),
        ]
    elif kind == 'mixed':
        fields = [(ys + 6.0 * np.sin(2 * np.pi * xs / W),
                   xs + 4.0 * np.sin(2 * np.pi * ys / H))]
    else:
        # 'far': the second sample reads 1900 px to the left of the image,
        # so pass H needs more low padding than the 2048-lane window has
        # and the plan takes the padded roll kernel.
        fields = [(ys + 6.0 * np.sin(2 * np.pi * xs / W),
                   xs + 4.0 * np.sin(2 * np.pi * ys / H)),
                  (ys, xs - 1900.0)]
    return (np.stack([f[0] for f in fields]),
            np.stack([f[1] for f in fields]))


def _window_ok(m_in, statics):
    rel_min = -statics.pad_lo
    rel_max = statics.m_padded - 1024 - statics.pad_lo
    return (m_in + statics.m_shift <= 2048
            and rel_min >= -(2048 - m_in - statics.m_shift)
            and rel_max <= 2048 - statics.m_shift)


def _as_numpy(plan):
    return [np.asarray(v) for v in plan]


def _same_dense_plan(ref, got):
    (ref_plan, ref_statics), (plan, statics) = ref, got
    assert_same_value(
        [_as_numpy(ref_plan.pass_v), _as_numpy(ref_plan.pass_h),
         tuple(ref_statics.statics_v), tuple(ref_statics.statics_h)],
        [_as_numpy(plan.pass_v), _as_numpy(plan.pass_h),
         tuple(statics.statics_v), tuple(statics.statics_h)], 'dense plan')


@pytest.mark.parametrize('seed', [0, 1])
def test_plan_dense_line_resample_equals_reference(seed):
    rng = np.random.default_rng(seed)
    slope = rng.uniform(0.8, 1.2, (3, 1, 1)) * (1 if seed == 0 else -1)
    pos = (slope * np.arange(80)[None, None, :]
           + rng.uniform(-30, 30, (3, 40, 1))
           + rng.uniform(0, 3, (3, 40, 80)))
    ref_plan, ref_statics = JWM.plan_dense_line_resample(pos, 96)
    plan, statics = TWM.plan_dense_line_resample(pos, 96)
    assert all(isinstance(v, np.ndarray) for v in plan)
    assert_same_value([_as_numpy(ref_plan), tuple(ref_statics)],
                      [_as_numpy(plan), tuple(statics)], 'line plan')
    np.testing.assert_array_equal(JWM.line_tap_needs(pos),
                                  TWM.line_tap_needs(pos))
    np.testing.assert_array_equal(JWM.line_window_needs(pos),
                                  TWM.line_window_needs(pos))


@pytest.mark.parametrize('kind', ['separable', 'mixed', 'far'])
def test_plan_dense_warp_equals_reference(kind):
    map_ys, map_xs = _fields(kind)
    ref_pos = JWM.dense_warp_positions(map_ys, map_xs, (H, W))
    pos = TWM.dense_warp_positions(map_ys, map_xs, (H, W))
    assert_same_value(list(ref_pos), list(pos), 'positions')
    _same_dense_plan(JWM.plan_dense_warp(map_ys, map_xs, (H, W)),
                     TWM.plan_dense_warp(map_ys, map_xs, (H, W)))


def test_plan_dense_warp_rejects_what_the_reference_rejects():
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    fold = xs.copy()
    fold[:, 60:] -= 20.0                      # map_x folds back: not monotone
    for planner in (JWM.plan_dense_warp, TWM.plan_dense_warp):
        with pytest.raises(AssertionError):
            planner(ys[None], fold[None], (H, W))
    # The slope along x varies from line to line: far more than 24 taps.
    wild = xs + 40.0 * np.sin(ys / 3.0) * xs / W
    for planner in (JWM.plan_dense_warp, TWM.plan_dense_warp):
        with pytest.raises(AssertionError):
            planner(ys[None], wild[None], (H, W))


def _apply_both(image, map_ys, map_xs, border_value=0.0, dtype=np.float32):
    n = len(map_ys)
    imgs = np.stack([image] * n).astype(dtype)
    ref_plan, ref_statics = JWM.plan_dense_warp(map_ys, map_xs, (H, W))
    plan, statics = TWM.plan_dense_warp(map_ys, map_xs, (H, W))
    _same_dense_plan((ref_plan, ref_statics), (plan, statics))
    ref = np.asarray(JWM.apply_dense_warp(
        jnp.asarray(imgs), ref_plan, ref_statics, border_value=border_value))
    got = TWM.apply_dense_warp(
        torch.from_numpy(imgs), convert.dense_warp_plan(plan, 'cpu'),
        statics, border_value=border_value)
    return ref, got, statics


def test_separable_fields_exact(smooth_image):
    """The port's twin of tests/ops/test_dense_warp.py::
    test_separable_fields_exact: within 1e-4 of vkit_tpu (float32, the
    same taps in the same order) and within 1e-3 of the exact remap."""
    map_ys, map_xs = _fields('separable')
    ref, got, statics = _apply_both(smooth_image, map_ys, map_xs)
    assert _window_ok(H, statics.statics_v) and _window_ok(W, statics.statics_h)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert np.abs(ref - got.numpy()).max() <= 1e-4
    for i in range(len(map_ys)):
        exact = remap_np(smooth_image, map_ys[i].astype(np.float32),
                         map_xs[i].astype(np.float32))
        assert np.abs(got[i].numpy() - exact).max() < 1e-3


def test_mixed_field_close(smooth_image):
    """The port's twin of tests/ops/test_dense_warp.py::
    test_mixed_field_close: within 1e-4 of vkit_tpu, and within 1.0 of the
    exact remap in the interior (the two-pass footprint is sheared)."""
    map_ys, map_xs = _fields('mixed')
    ref, got, _ = _apply_both(smooth_image, map_ys, map_xs, border_value=7.0)
    assert np.abs(ref - got.numpy()).max() <= 1e-4
    my, mx = map_ys[0], map_xs[0]
    exact = remap_np(smooth_image, my.astype(np.float32),
                     mx.astype(np.float32))
    interior = (my > 2) & (my < H - 3) & (mx > 2) & (mx < W - 3)
    assert np.abs(got[0].numpy() - exact)[interior].max() < 1.0


def test_dense_warp_roll_route_matches_jax(smooth_image, monkeypatch):
    """A plan that fails the window test pads and takes ``row_shift`` (its
    plain version here) in pass H; the other pass keeps the window
    kernel."""
    calls = []
    for name in ('row_shift', 'row_shift_window_slab'):
        real = getattr(TWM, name)
        monkeypatch.setattr(
            TWM, name,
            lambda *a, _real=real, _name=name, **k: (
                calls.append(_name), _real(*a, **k))[1])
    map_ys, map_xs = _fields('far')
    ref, got, statics = _apply_both(smooth_image, map_ys, map_xs,
                                    border_value=11.0)
    assert _window_ok(H, statics.statics_v)
    assert not _window_ok(W, statics.statics_h)
    assert calls == ['row_shift_window_slab', 'row_shift']
    assert np.abs(ref - got.numpy()).max() <= 1e-4
    assert np.abs(got[1].numpy() - 11.0).max() == 0    # all border


def test_dense_warp_uint8_and_wrapper(smooth_image):
    """uint8 in, uint8 out, through ``warp_dense_batch_mxu``; a pixel may
    differ by 1 where the float32 value lies on a rounding tie."""
    map_ys, map_xs = _fields('mixed')
    imgs = smooth_image[None].astype(np.uint8)
    ref = np.asarray(JWM.warp_dense_batch_mxu(jnp.asarray(imgs), map_ys,
                                              map_xs))
    got = TWM.warp_dense_batch_mxu(torch.from_numpy(imgs), map_ys, map_xs)
    assert got.dtype == torch.uint8
    assert np.abs(ref.astype(int) - got.numpy().astype(int)).max() <= 1
    gray = TWM.warp_dense_batch_mxu(torch.from_numpy(imgs[..., 0]), map_ys,
                                    map_xs)
    assert torch.equal(gray, got[..., 0])


def test_warp_affine_batch_mxu_matches_jax(smooth_image):
    from tests.ops.test_warp_mxu import _fwd_mat

    mats = np.stack([_fwd_mat(H, W, 12, tx=2.5), _fwd_mat(H, W, -8, shear=6)])
    imgs = np.stack([smooth_image] * 2)
    ref = np.asarray(JWM.warp_affine_batch_mxu(jnp.asarray(imgs), mats,
                                               border_value=5.0))
    got = TWM.warp_affine_batch_mxu(torch.from_numpy(imgs), mats,
                                    border_value=5.0)
    assert np.abs(ref - got.numpy()).max() <= 1e-3


_MILD_CAMERA = {
    'curve_alpha': 2, 'curve_beta': -2, 'curve_direction': 0,
    'curve_scale': 1.0,
    'camera_model_config': {'rotation_unit_vec': [1.0, 0.0, 0.0],
                            'rotation_theta': 2},
    'grid_size': 16,
}
_STRONG_CAMERA = {
    'curve_alpha': 40, 'curve_beta': -40, 'curve_direction': 30,
    'curve_scale': 1.0,
    'camera_model_config': {'rotation_unit_vec': [0.6, 0.8, 0.0],
                            'rotation_theta': 30},
    'grid_size': 16,
}


@pytest.mark.parametrize('route,cases', [
    ('two_pass', [('rotate', {'angle': 4}), ('shear_hori', {'angle': 5}),
                  ('camera_cubic_curve', _MILD_CAMERA)]),
    ('gather', [('rotate', {'angle': 4}), ('shear_hori', {'angle': 5}),
                ('camera_cubic_curve', _STRONG_CAMERA)]),
])
@pytest.mark.parametrize('return_maps', [False, True])
def test_batched_plan_warp_dense_matches_jax(smooth_image, monkeypatch,
                                             route, cases, return_maps):
    """``mode='dense'`` against vkit_tpu inside the active mask: a batch the
    two-pass accepts (within 1e-3: float32 images, the same taps), and one
    whose strong camera draw sends the whole batch to the bilinear gather
    (within 0.5, mean 0.01: the node-upsample sums run in another order)."""
    taken = []
    real = TB.apply_dense_warp
    monkeypatch.setattr(
        TB, 'apply_dense_warp',
        lambda *a, **k: (taken.append('two_pass'), real(*a, **k))[1])
    ref_plans, plans = _plan_pair(cases, (H, W))
    imgs = np.stack([smooth_image] * len(cases))
    ref = JB.batched_plan_warp(ref_plans, jnp.asarray(imgs), mode='dense',
                               border_value=3.0, return_maps=return_maps)
    got = TB.batched_plan_warp(plans, torch.from_numpy(imgs), mode='dense',
                               border_value=3.0, return_maps=return_maps)
    assert taken == (['two_pass'] if route == 'two_pass' else [])
    assert got[1] == ref[1]
    assert got[0].dtype == torch.float32
    assert tuple(got[0].shape) == np.asarray(ref[0]).shape
    for a, b in zip(ref[2], got[2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d = _active_diff(np.asarray(ref[0]), got[0].numpy(), plans, got[1])
    if route == 'two_pass':
        assert d.max() <= 1e-3
    else:
        assert d.max() <= 0.5 and d.mean() <= 0.01
    if return_maps:
        for k in range(2):
            assert np.abs(np.asarray(ref[3][k])
                          - np.asarray(got[3][k])).max() <= 1e-3


def test_dense_mode_close_to_gather_mode():
    """The port's two routes on one mild batch at 256 px (a smooth image):
    mean within 0.5 LSB inside the active mask eroded by 4 px, max within 8
    LSB inside it eroded by one 16-px node cell.  The two-pass filters with
    a sheared footprint and the gather reads node-interpolated positions;
    the smoke run on a card holds its 640 px batch to the same numbers."""
    from scipy.ndimage import binary_erosion, gaussian_filter

    from vkit_tpu_torch.mechanism import distortion as D
    from vkit_tpu_torch.mechanism.distortion.warp_plan import warp_active_mask

    side = 256
    image = gaussian_filter(
        np.random.default_rng(0).random((side, side, 3)) * 255,
        sigma=(2, 2, 0)).astype(np.float32)
    cases = [('rotate', {'angle': 4}), ('shear_hori', {'angle': 5}),
             ('camera_cubic_curve', _MILD_CAMERA)]
    plans = [getattr(D, name).plan(cfg, (side, side),
                                   np.random.default_rng(0))
             for name, cfg in cases]
    imgs = torch.from_numpy(np.stack([image] * len(cases)))
    dense, shapes, _ = TB.batched_plan_warp(plans, imgs, mode='dense')
    gather = TB.batched_plan_warp(plans, imgs, mode='gather')[0]
    diff = (dense - gather).abs().amax(dim=-1).numpy()
    for i, plan in enumerate(plans):
        h, w = shapes[i]
        active = warp_active_mask(plan).mat.astype(bool)
        near = binary_erosion(active, iterations=4)
        core = binary_erosion(active, iterations=16)
        assert core.sum() > side * side // 2
        assert diff[i, :h, :w][near].mean() <= 0.5
        assert diff[i, :h, :w][core].max() <= 8.0
