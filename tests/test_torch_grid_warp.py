"""The port's batched_grid_warp (vkit_tpu_torch/mechanism/batched.py)
against vkit_tpu's on the same inputs: camera and MLS configs route to the
banded two-pass (K3 on a card), rotate configs to the two-shear warp (K1).
Each package plans with its own planners from one seed, and the plans are
checked equal before any pixel is; vkit_tpu's Pallas kernels run in
interpret mode here, the port's wrappers their plain versions.

Also the reference's own dense-vs-gather gap at the plans behind
chip_smoke.py's dense-640 measurement:

    python -m tests.test_torch_grid_warp [SIDE]

prints the mean LSB gap 4 px inside the active masks and the max 16 px
inside, on the CPU, for vkit_tpu and for the port (SIDE 640 by default;
the test runs 320)."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_erosion, gaussian_filter

from tests.test_torch_host import assert_same_plans
from vkit_tpu.element import Point as JaxPoint
from vkit_tpu.element import PointTuple as JaxPointTuple
from vkit_tpu.mechanism import batched as JB
from vkit_tpu.mechanism import distortion as JD
from vkit_tpu.mechanism.distortion.warp_plan import (
    warp_active_mask as jax_warp_active_mask,
)
from vkit_tpu_torch import convert
from vkit_tpu_torch.element import Point, PointTuple
from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.mechanism import distortion as D
from vkit_tpu_torch.mechanism.distortion.warp_plan import warp_active_mask
from vkit_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# chip_smoke.py's dense-640 batch: DENSE_SEED, 8 samples, 672 x 672 canvas.
DENSE_SEED = 700
DENSE_CANVAS = (672, 672)


def _stack(side, seed=0, channels=5):
    """A smooth uint8-valued float32 image plus label planes, as bench
    configs 2-4 stack RGB with a mask and a score map."""
    rng = np.random.default_rng(seed)
    rgb = gaussian_filter(rng.random((side, side, 3)) * 255,
                          sigma=(2, 2, 0)).round()
    labels = np.stack([np.ones((side, side)),
                       rng.random((side, side)).round()], axis=-1)
    return np.concatenate([rgb, labels], axis=-1)[..., :channels].astype(
        np.float32)


def _camera(theta, alpha, beta):
    return {
        'curve_alpha': alpha, 'curve_beta': beta, 'curve_direction': 0.0,
        'curve_scale': 1.0,
        'camera_model_config': {'rotation_unit_vec': [1.0, 0.0, 0.0],
                                'rotation_theta': theta},
        'grid_size': 10,
    }


def _mls(package, side, dy, dx):
    point, points = ((JaxPoint, JaxPointTuple) if package == 'jax'
                     else (Point, PointTuple))
    corners = [(0, 0), (0, side - 1), (side - 1, side - 1), (side - 1, 0)]
    src = points([point.create(y=y, x=x) for y, x in corners]
                 + [point.create(y=side // 2, x=side // 2)])
    dst = points([point.create(y=y, x=x) for y, x in corners]
                 + [point.create(y=side // 2 + dy, x=side // 2 + dx)])
    return {'src_handle_points': src, 'dst_handle_points': dst,
            'grid_size': 12}


CASES = {
    # tests/ops/test_dense_warp.py's camera and MLS configs, and rotates
    # (bench config 2 rotates by 17 degrees).
    'camera': ('camera_cubic_curve', 96, lambda package, side: [
        _camera(2, -4, -4), _camera(3, 3, 5), _camera(10, -20, -20),
        _camera(15, 15, 25)]),
    'mls': ('similarity_mls', 112, lambda package, side: [
        _mls(package, side, 5, 3), _mls(package, side, -4, 6)]),
    'rotate': ('rotate', 128, lambda package, side: [
        {'angle': 17.0}, {'angle': -5.5}, {'angle': 101.0}]),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_batched_grid_warp_matches_jax(case):
    """Twin of tests/ops/test_dense_warp.py::test_batched_grid_warp_camera /
    _mls, held to vkit_tpu's own output: plans equal, then the pixels
    within 1 LSB inside each sample's coverage eroded by 4 px."""
    name, side, configs = CASES[case]
    stack = _stack(side)
    ref_configs = configs('jax', side)
    got_configs = configs('torch', side)
    assert_same_plans(
        [getattr(JD, name).plan(c, (side, side), np.random.default_rng(1))
         for c in ref_configs],
        [getattr(D, name).plan(c, (side, side), np.random.default_rng(1))
         for c in got_configs])

    images = np.stack([stack] * len(ref_configs))
    ref, ref_shapes, ref_covs = JB.batched_grid_warp(
        getattr(JD, name), ref_configs, jnp.asarray(images),
        rng=np.random.default_rng(1))
    K.reset_launch_counts()
    got, shapes, covs = TB.batched_grid_warp(
        getattr(D, name), got_configs, images,
        rng=np.random.default_rng(1), device='cpu')
    assert sum(K.LAUNCHES.values()) == 0  # the plain versions on the CPU
    assert shapes == ref_shapes
    assert got.shape == ref.shape and got.dtype == torch.float32
    ref = np.asarray(ref)
    got = got.numpy()
    for i, (h, w) in enumerate(shapes):
        np.testing.assert_array_equal(covs[i], ref_covs[i])
        core = binary_erosion(covs[i], iterations=4)
        assert core.sum() > h * w // 4
        diff = np.abs(got[i, :h, :w] - ref[i, :h, :w])[core]
        assert diff.max() <= 1.0, (i, diff.max())
        assert diff.mean() <= 0.01, (i, diff.mean())


def test_batched_grid_warp_device_rules():
    """A tensor batch stays on its device; a numpy batch goes to the card
    unless the caller asks for the CPU, and without a card that raises."""
    stack = _stack(64)[None]
    configs = [{'angle': 9.0}]
    out, shapes, _ = TB.batched_grid_warp(D.rotate, configs,
                                          torch.from_numpy(stack))
    assert out.device.type == 'cpu'
    same, _, _ = TB.batched_grid_warp(D.rotate, configs, stack,
                                      device='cpu')
    assert torch.equal(out, same)
    if not torch.cuda.is_available():
        with pytest.raises(convert.DeviceError):
            TB.batched_grid_warp(D.rotate, configs, stack)


# ---------------------------------------------------------------------------
# The reference's dense-vs-gather gap.
# ---------------------------------------------------------------------------


def _mild_camera_config(rng):
    """chip_smoke.py's _mild_camera_plan config, drawn from ``rng``."""
    axis = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]][int(rng.integers(0, 2))]
    return {
        'curve_alpha': float(rng.uniform(-1.5, 1.5)),
        'curve_beta': float(rng.uniform(-1.5, 1.5)),
        'curve_direction': float(rng.uniform(0, 45)),
        'curve_scale': 1.0,
        'camera_model_config': {
            'rotation_unit_vec': axis,
            'rotation_theta': float(rng.uniform(-1.0, 1.0)),
        },
        'grid_size': 32,
    }


def dense_inputs(side, batch=8, seed=DENSE_SEED):
    """chip_smoke.py's dense_inputs, drawn for both packages: the smooth
    5-plane stack and the first ``batch`` mild camera plans whose field
    the port's dense two-pass takes alone (vkit_tpu's plans, the port's;
    both packages route alike)."""
    gen = np.random.default_rng(seed)
    stack = gaussian_filter(
        gen.random((batch, side, side, 5)) * 255, sigma=(0, 2, 2, 0)
    ).astype(np.float32)
    canvas = DENSE_CANVAS if side == 640 else (side + side // 20,) * 2
    ref_plans, plans, drawn = [], [], 0
    taken = []
    real = TB.apply_dense_warp

    def spy(*args, **kwargs):
        taken.append(True)
        return real(*args, **kwargs)

    while len(plans) < batch:
        assert drawn < 20 * batch
        state = gen.bit_generator.state
        config = _mild_camera_config(gen)
        plan = D.camera_cubic_curve.plan(config, (side, side), gen)
        twin = np.random.default_rng()
        twin.bit_generator.state = state
        ref_plan = JD.camera_cubic_curve.plan(_mild_camera_config(twin),
                                              (side, side), twin)
        assert_same_plans([ref_plan], [plan])
        drawn += 1
        taken.clear()
        TB.apply_dense_warp = spy
        try:
            TB.batched_plan_warp([plan], torch.from_numpy(stack[:1]),
                                 mode='dense', canvas_shape=canvas)
        finally:
            TB.apply_dense_warp = real
        if taken:
            plans.append(plan)
            ref_plans.append(ref_plan)
    return stack, ref_plans, plans, canvas


def dense_vs_gather(warp, plans, active_mask, stack, canvas):
    """(mean LSB gap 4 px inside the active masks, max gap 16 px inside)
    between ``warp``'s dense and gather modes, the worst sample of each."""
    dense = np.asarray(warp(plans, stack, mode='dense',
                            canvas_shape=canvas)[0])
    gather = np.asarray(warp(plans, stack, mode='gather',
                             canvas_shape=canvas)[0])
    diff = np.abs(dense - gather).max(axis=-1)
    mean_gap = max_gap = 0.0
    for i, plan in enumerate(plans):
        h, w = plan.dst_shape
        active = active_mask(plan).mat.astype(bool)
        near = binary_erosion(active, iterations=4)
        core = binary_erosion(active, iterations=16)
        mean_gap = max(mean_gap, float(diff[i, :h, :w][near].mean()))
        max_gap = max(max_gap, float(diff[i, :h, :w][core].max()))
    return mean_gap, max_gap


def measure_dense_vs_gather(side, batch=8):
    stack, ref_plans, plans, canvas = dense_inputs(side, batch)
    ref = dense_vs_gather(JB.batched_plan_warp, ref_plans,
                          jax_warp_active_mask, jnp.asarray(stack), canvas)
    got = dense_vs_gather(TB.batched_plan_warp, plans, warp_active_mask,
                          torch.from_numpy(stack), canvas)
    return ref, got


def test_dense_vs_gather_gap_is_the_reference_own():
    """The port's dense-vs-gather gap (chip_smoke.py phase 6) is the
    reference's: both packages show the same gap at the same plans, within
    1e-3 LSB, and under phase 6's bounds (mean 0.5, max 8 LSB)."""
    (ref_mean, ref_max), (mean, max_) = measure_dense_vs_gather(320, batch=2)
    assert ref_mean > 0.05 and ref_max > 0.5
    assert abs(mean - ref_mean) <= 1e-3 and abs(max_ - ref_max) <= 1e-3
    assert ref_mean <= 0.5 and ref_max <= 8.0


if __name__ == '__main__':
    SIDE = int(sys.argv[1]) if len(sys.argv) > 1 else 640
    (REF_MEAN, REF_MAX), (GOT_MEAN, GOT_MAX) = measure_dense_vs_gather(SIDE)
    print(f'dense vs gather at {SIDE} px, 8 mild camera plans (seed '
          f'{DENSE_SEED}), LSB: vkit_tpu mean {REF_MEAN} (4 px in) max '
          f'{REF_MAX} (16 px in); vkit_tpu_torch mean {GOT_MEAN} max '
          f'{GOT_MAX}')
