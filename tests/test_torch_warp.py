"""The port's geometric stage (vkit_tpu_torch/ops/warp_*.py,
vkit_tpu_torch/mechanism/batched*.py) against vkit_tpu on the same inputs;
each package plans with its own host planners (plans checked equal first);
vkit_tpu's Pallas kernels run in interpret mode here, the port's wrappers
run their plain versions."""
import copy

import attr
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ops.test_warp_mxu import _fwd_mat
from tests.test_torch_host import assert_same_plans, assert_same_value
from vkit_tpu.mechanism import batched as JB
from vkit_tpu.mechanism import distortion as JD
from vkit_tpu.mechanism.batched_random import (
    batch_random_geometric_distort as jax_random_geometric,
)
from vkit_tpu.mechanism.batched_random import (
    sample_geometric_plans as jax_sample_geometric_plans,
)
from vkit_tpu.mechanism.distortion.warp_plan import (
    matrix_plan as jax_matrix_plan,
)
from vkit_tpu.mechanism.distortion.warp_plan import (
    rescale_plan_to as jax_rescale_plan_to,
)
from vkit_tpu.ops import warp_banded as JWB
from vkit_tpu.ops import warp_mxu as JWM
from vkit_tpu_torch import convert
from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.mechanism import distortion as D
from vkit_tpu_torch.mechanism.batched_random import (
    batch_random_geometric_distort,
    sample_geometric_plans,
)
from vkit_tpu_torch.mechanism.distortion.warp_plan import (
    matrix_plan,
    rescale_plan_to,
    warp_active_mask,
)
from vkit_tpu_torch.ops import kernels as K
from vkit_tpu_torch.ops import warp_banded as TWB
from vkit_tpu_torch.ops import warp_mxu as TWM

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def smooth_image():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    return gaussian_filter(
        rng.random((96, 96, 3)) * 255, sigma=2
    ).astype(np.float32)


@pytest.fixture(scope='module')
def page_images():
    """The smooth page-like card of tests/mechanism/test_batched.py."""
    h, w = 96, 128
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    img = np.stack([
        np.clip(
            127.5
            + 70 * np.sin(2 * np.pi * xs / 37 + c)
            + 55 * np.cos(2 * np.pi * ys / 23 - 0.7 * c)
            + 0.2 * xs - 0.1 * ys,
            0, 255,
        ) for c in range(3)
    ], axis=-1).astype(np.uint8)
    return np.stack([img, img[::-1].copy(), img[:, ::-1].copy()])


def _spread_plans(n, height, rng, matrix_plan=matrix_plan):
    """Deskew + crop one 700-px half of each (height x 1400) spread: the
    pass-H span (~700) fails the 2048-lane window and routes row_shift."""
    plans = []
    cy = (height - 1) / 2
    for idx in range(n):
        theta = np.radians(rng.uniform(-1.5, 1.5))
        cx = 350.0 if idx % 2 == 0 else 1050.0
        cos, sin = np.cos(theta), np.sin(theta)
        mat = np.asarray([
            [cos, -sin, 349.5 - cos * cx + sin * cy],
            [sin, cos, cy - sin * cx - cos * cy],
            [0.0, 0.0, 1.0],
        ])
        plans.append(matrix_plan(mat, (height, 1400), (height, 700)))
    return plans


def _plan_pair(cases, shape, seed=0):
    """((distortion name, config), ...) planned by each package from the
    same seed: (vkit_tpu's plans, the port's), checked equal."""
    ref = [getattr(JD, name).plan(cfg, shape, np.random.default_rng(seed))
           for name, cfg in cases]
    got = [getattr(D, name).plan(cfg, shape, np.random.default_rng(seed))
           for name, cfg in cases]
    assert_same_plans(ref, got)
    return ref, got


def _same_affine_plan(ref, got):
    (ref_plan, ref_statics), (plan, statics) = ref, got
    assert_same_value([tuple(ref_plan.pass_v), tuple(ref_plan.pass_h),
                       tuple(ref_statics)],
                      [tuple(plan.pass_v), tuple(plan.pass_h),
                       tuple(statics)], 'affine plan')


def _active_diff(ref, got, plans, shapes):
    """Per-sample |ref - got| inside each plan's active mask."""
    out = []
    for i, plan in enumerate(plans):
        h, w = shapes[i]
        act = warp_active_mask(plan).mat.astype(bool)
        d = np.abs(ref[i, :h, :w].astype(np.float64)
                   - got[i, :h, :w].astype(np.float64))
        out.append(d[act])
    return np.concatenate(out)


@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
def test_apply_affine_warp_matches_jax(smooth_image, dtype):
    h, w = smooth_image.shape[:2]
    mats = np.stack([
        _fwd_mat(h, w, 0, tx=3.25, ty=-7.5),
        _fwd_mat(h, w, 17),
        _fwd_mat(h, w, -23, scale=0.9, shear=10, tx=5),
    ])
    imgs = np.stack([smooth_image] * 3).astype(dtype)
    ref_plan, ref_statics = JWM.plan_affine_warp(mats, (h, w))
    plan, statics = TWM.plan_affine_warp(mats, (h, w))
    _same_affine_plan((ref_plan, ref_statics), (plan, statics))
    ref = np.asarray(JWM.apply_affine_warp(jnp.asarray(imgs), ref_plan,
                                           ref_statics, border_value=3.0))
    got = TWM.apply_affine_warp(
        torch.from_numpy(imgs), convert.affine_warp_plan(plan, 'cpu'),
        statics, border_value=3.0,
    ).numpy()
    assert got.dtype == ref.dtype
    if dtype == np.uint8:
        assert np.abs(ref.astype(int) - got.astype(int)).max() <= 1
    else:
        assert np.abs(ref - got).max() <= 1e-3


def test_apply_affine_warp_quad_matches_jax(smooth_image):
    h, w = smooth_image.shape[:2]
    mats = np.stack([_fwd_mat(h, w, a) for a in (10, 100, 185, -95)])
    ref_quads, ref_reduced = JWM.quadrant_reduce_mats(mats, (h, w))
    quads, reduced = TWM.quadrant_reduce_mats(mats, (h, w))
    assert_same_value([ref_quads, ref_reduced], [quads, reduced], 'quads')
    assert set(quads.tolist()) == {0, 1, 2, 3}
    ref_plan, ref_statics = JWM.plan_affine_warp(ref_reduced, (h, w),
                                                 canonical=True)
    plan, statics = TWM.plan_affine_warp(reduced, (h, w), canonical=True)
    _same_affine_plan((ref_plan, ref_statics), (plan, statics))
    imgs = np.stack([smooth_image] * 4)
    ref = np.asarray(JWM.apply_affine_warp_quad(
        jnp.asarray(imgs), jnp.asarray(ref_quads), ref_plan, ref_statics
    ))
    got = TWM.apply_affine_warp_quad(
        torch.from_numpy(imgs), quads, convert.affine_warp_plan(plan, 'cpu'),
        statics,
    ).numpy()
    assert np.abs(ref - got).max() <= 1e-3


def test_row_shift_route_matches_jax():
    """A 1400-px source resampled to 700 outputs takes the padded
    row_shift kernel in both packages."""
    rng = np.random.default_rng(5)
    ref_plans = _spread_plans(2, 24, copy.deepcopy(rng), jax_matrix_plan)
    plans = _spread_plans(2, 24, rng)
    assert_same_plans(ref_plans, plans)
    imgs = rng.integers(0, 256, (2, 24, 1400, 3), dtype=np.uint8)
    ref = np.asarray(JB.batched_plan_warp(ref_plans, imgs,
                                          border_value=255)[0])
    got, shapes, _ = TB.batched_plan_warp(plans, torch.from_numpy(imgs),
                                          border_value=255)
    assert tuple(got.shape) == ref.shape == (2, 24, 700, 3)
    d = _active_diff(ref, got.numpy(), plans, shapes)
    assert d.max() <= 1


def test_apply_banded_warp_matches_jax(page_images):
    h, w = page_images.shape[1:3]
    cfg = {
        'curve_alpha': 12, 'curve_beta': -10, 'curve_direction': 0,
        'curve_scale': 1.0,
        'camera_model_config': {'rotation_unit_vec': [1.0, 0.0, 0.0],
                                'rotation_theta': 6},
        'grid_size': 16,
    }
    ref_plans, plans = [], []
    for name, c, seed in (('camera_cubic_curve', cfg, 0),
                          ('camera_cubic_curve', cfg, 1),
                          ('rotate', {'angle': 160}, 0)):
        ref_pair, pair = _plan_pair([(name, c)], (h, w), seed)
        ref_plans += ref_pair
        plans += pair
    shapes = [p.dst_shape for p in plans]
    canvas = (max(s[0] for s in shapes), max(s[1] for s in shapes))
    ref_nodes = JB._build_coarse_nodes(ref_plans, shapes, canvas)
    nodes = TB._build_coarse_nodes(plans, shapes, canvas)
    ref_planned = JWB.plan_banded_warp(*ref_nodes, (h, w), canvas)
    planned = TWB.plan_banded_warp(*nodes, (h, w), canvas)
    assert_same_value(
        [list(ref_nodes), tuple(ref_planned[0].pass_v),
         tuple(ref_planned[0].pass_h), list(ref_planned[1:])],
        [list(nodes), tuple(planned[0].pass_v), tuple(planned[0].pass_h),
         list(planned[1:])], 'banded plan')
    plan, taps, rejects, flips, _ = planned
    assert len(rejects) == 0 and flips[0].any()    # the 160-degree flips
    x = page_images[:3].astype(np.float32)
    ref = np.asarray(JWB.apply_banded_warp(
        jnp.asarray(x), ref_planned[0], canvas, taps, flips=flips,
        border_value=9.0,
    ))
    got = TWB.apply_banded_warp(
        torch.from_numpy(x), convert.banded_warp_plan(plan, 'cpu'), canvas,
        taps, flips=flips, border_value=9.0,
    ).numpy()
    # The node-upsample sums run in another order: tiny position shifts.
    d = _active_diff(ref, got, plans, shapes)
    assert d.max() <= 0.5 and d.mean() <= 0.01


@pytest.mark.parametrize('return_maps', [False, True])
@pytest.mark.parametrize('mode', ['auto', 'gather'])
def test_batched_plan_warp_mixed_matches_jax(page_images, mode, return_maps):
    """Mirror of tests/mechanism/test_batched.py::
    test_batched_geometric_vs_per_element: affine + shear + camera in one
    batch, held to vkit_tpu's own output."""
    h, w = page_images.shape[1:3]
    cases = [
        ('rotate', {'angle': 25}),
        ('shear_hori', {'angle': 12}),
        ('camera_cubic_curve', {
            'curve_alpha': 12, 'curve_beta': -10, 'curve_direction': 0,
            'curve_scale': 1.0,
            'camera_model_config': {'rotation_unit_vec': [1.0, 0.0, 0.0],
                                    'rotation_theta': 6},
            'grid_size': 16,
        }),
    ]
    ref_plans, plans = _plan_pair(cases, (h, w))
    ref = JB.batched_plan_warp(ref_plans, page_images, mode=mode,
                               return_maps=return_maps)
    got = TB.batched_plan_warp(plans, torch.from_numpy(page_images),
                               mode=mode, return_maps=return_maps)
    assert got[1] == ref[1]
    assert got[0].dtype == torch.uint8
    d = _active_diff(np.asarray(ref[0]), got[0].numpy(), plans, got[1])
    assert d.max() <= 1 and d.mean() <= 0.01
    if return_maps:
        for k in range(2):
            assert np.abs(np.asarray(ref[3][k])
                          - got[3][k].numpy()).max() <= 1e-3


def test_downscale_tail_matches_jax():
    """Mirror of tests/mechanism/test_batched.py::
    test_downscale_tail_matches_gather: a draw whose tap need exceeds the
    ladder takes the 2x mean-pool tail in both packages."""
    side, out_shape = 320, (352, 352)
    ref_rng, rng = np.random.default_rng(11), np.random.default_rng(11)
    found = None
    for _ in range(600):
        ref_plans = [jax_rescale_plan_to(p, out_shape) for p in
                     jax_sample_geometric_plans(8, (side, side), 9, ref_rng)]
        plans = [rescale_plan_to(p, out_shape) for p in
                 sample_geometric_plans(8, (side, side), 9, rng)]
        lat = [p for p in plans if p.is_lattice]
        if not lat:
            continue
        nodes = TB._build_coarse_nodes(
            lat, [p.dst_shape for p in lat], out_shape
        )
        planned = TWB.plan_banded_warp(
            nodes[0], nodes[1], nodes[2], nodes[3], (side, side), out_shape
        )
        if planned is None:
            continue
        if TWB._LAST_NEEDS.max() > 128:
            pick = int(np.argmax(TWB._LAST_NEEDS))
            found = lat[pick]
            ref_found = [p for p in ref_plans if p.is_lattice][pick]
            break
    assert found is not None, 'no high-needs draw found'
    assert_same_plans([ref_found], [found])

    img = np.clip(
        np.cumsum(np.cumsum(
            np.random.default_rng(0).normal(size=(side, side, 3)), 0), 1)
        % 255, 0, 255,
    ).astype(np.uint8)
    plans2 = [found]
    imgs = img[None]
    ref = np.asarray(JB.batched_plan_warp([ref_found], imgs,
                                          mode='auto')[0])
    got, shapes, _ = TB.batched_plan_warp(plans2, torch.from_numpy(imgs),
                                          mode='auto')
    d = _active_diff(ref, got.numpy(), plans2, shapes)
    assert d.max() <= 1 and d.mean() <= 0.01


def test_oversized_source_falls_back_to_gather():
    """Mirror of tests/ops/test_dense_warp.py::
    test_banded_plan_rejects_oversized_sources: a perspective field on a
    1600-px source exceeds the banded window, so the whole batch takes the
    bilinear-gather program in both packages."""
    rng = np.random.default_rng(2)
    h, w = 24, 1600
    mats = [np.asarray([[1.0, 0.02, 3.0], [0.0, 1.0, -1.5],
                        [s * 1e-6, 0.0, 1.0]]) for s in (1.0, -2.0)]
    ref_plans = [jax_matrix_plan(m, (h, w), (h, w)) for m in mats]
    plans = [matrix_plan(m, (h, w), (h, w)) for m in mats]
    assert_same_plans(ref_plans, plans)
    imgs = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    ref = np.asarray(JB.batched_plan_warp(ref_plans, imgs)[0])
    got, shapes, _ = TB.batched_plan_warp(plans, torch.from_numpy(imgs))
    d = _active_diff(ref, got.numpy(), plans, shapes)
    assert d.max() <= 1


def test_coarse_nodes_16px_fidelity():
    """Mirror of tests/ops/test_dense_warp.py::
    test_coarse_nodes_16px_fidelity for the port: on a 384 px canvas
    (16-px nodes) the banded route stays within the documented bars of the
    exact per-element host warp."""
    from scipy.ndimage import binary_erosion, gaussian_filter

    from vkit_tpu.element import Image
    from vkit_tpu.mechanism.distortion import (
        CameraCubicCurveConfig,
        CameraModelConfig,
        camera_cubic_curve,
    )

    rng = np.random.default_rng(0)
    h = w = 384
    img = gaussian_filter(rng.random((h, w, 3)) * 255,
                          sigma=2).astype(np.uint8)
    configs = [
        CameraCubicCurveConfig(
            curve_alpha=-18, curve_beta=-18,
            curve_direction=0.0, curve_scale=1.0,
            camera_model_config=CameraModelConfig(
                rotation_unit_vec=[1.0, 0.0, 0.0], rotation_theta=12,
            ),
            grid_size=10,
        ),
        CameraCubicCurveConfig(
            curve_alpha=12, curve_beta=20,
            curve_direction=30.0, curve_scale=1.0,
            camera_model_config=CameraModelConfig(
                rotation_unit_vec=[0.0, 1.0, 0.0], rotation_theta=8,
            ),
            grid_size=10,
        ),
    ]
    ref_plans = [camera_cubic_curve.plan(cfg, (h, w),
                                         np.random.default_rng(1))
                 for cfg in configs]
    plans = [D.camera_cubic_curve.plan(attr.asdict(cfg),
                                       (h, w), np.random.default_rng(1))
             for cfg in configs]
    assert_same_plans(ref_plans, plans)
    warped, shapes, covs = TB.batched_plan_warp(
        plans, torch.from_numpy(np.stack([img] * 2))
    )
    warped = warped.numpy()
    for i, cfg in enumerate(configs):
        ref = camera_cubic_curve.distort_image(
            cfg, Image(mat=img), rng=np.random.default_rng(1)
        )
        hh, ww = shapes[i]
        assert ref.shape == (hh, ww)
        diff = np.abs(warped[i, :hh, :ww].astype(int) - ref.mat.astype(int))
        near = binary_erosion(covs[i], iterations=4)
        core = binary_erosion(covs[i], iterations=TB.COARSE_NODE_STEP)
        assert diff[near].mean() <= 1.0, diff[near].mean()
        assert diff[core].max() <= 24, diff[core].max()
        assert (diff[near].max(axis=-1) > 24).mean() <= 1e-3


def test_batch_random_geometric_distort_matches_jax():
    images = np.random.default_rng(3).integers(
        0, 256, (4, 80, 96, 3), dtype=np.uint8
    )
    assert_same_plans(
        jax_sample_geometric_plans(4, (80, 96), 4, np.random.default_rng(17)),
        sample_geometric_plans(4, (80, 96), 4, np.random.default_rng(17)),
    )
    ref, ref_active, ref_boxes = jax_random_geometric(
        images, 4, np.random.default_rng(17)
    )
    got, active, boxes = batch_random_geometric_distort(
        torch.from_numpy(images), 4, np.random.default_rng(17)
    )
    assert np.array_equal(active, ref_active)
    assert [(b.up, b.down, b.left, b.right) for b in boxes] == \
        [(b.up, b.down, b.left, b.right) for b in ref_boxes]
    on = active.astype(bool)
    d = np.abs(np.asarray(ref).astype(int) - got.numpy().astype(int))[on]
    assert d.max() <= 1


def test_kernel_counts_untouched_on_cpu(page_images):
    K.reset_launch_counts()
    plans = [D.rotate.plan({'angle': 25}, page_images.shape[1:3],
                           np.random.default_rng(0))] * 3
    TB.batched_plan_warp(plans, torch.from_numpy(page_images))
    assert sum(K.LAUNCHES.values()) == 0


def test_dense_mode_runs_and_unknown_mode_refused(page_images):
    """``mode='dense'`` runs (tests/test_torch_dense_warp.py holds it to
    vkit_tpu), and only an unknown mode is refused."""
    plans = [D.rotate.plan({'angle': 5}, page_images.shape[1:3],
                           np.random.default_rng(0))] * 3
    got, shapes, _ = TB.batched_plan_warp(
        plans, torch.from_numpy(page_images), mode='dense')
    assert got.dtype == torch.uint8 and shapes == [p.dst_shape for p in plans]
    with pytest.raises(ValueError):
        TB.batched_plan_warp(plans, torch.from_numpy(page_images),
                             mode='legacy')
