"""Where ``batched_plan_warp(mode='auto')`` sends the samples that the
banded plan rejects, on the CPU: every one takes the gather route, the
exact bilinear remap, whatever the reason it was rejected for (a tap need
at about a pixel a step, or a map that minifies), and nothing is planned
again at half resolution.
"""
import numpy as np
import pytest
import torch

from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.mechanism import distortion as D
from vkit_tpu_torch.mechanism.distortion.warp_plan import rescale_plan_to
from vkit_tpu_torch.ops import warp_banded as WB
from vkit_tpu_torch.utility import profiling

SIDE = 128
ROUTES = ('affine', 'banded', 'half', 'gather')


def _camera(theta, alpha, beta, direction, vec):
    return {
        'curve_alpha': alpha, 'curve_beta': beta,
        'curve_direction': direction, 'curve_scale': 1.0,
        'camera_model_config': {'rotation_unit_vec': list(vec),
                                'rotation_theta': theta},
        'grid_size': 15,
    }


MILD = _camera(2, -4, -4, 0.0, (1.0, 0.0, 0.0))
# Rejected beside MILD for its tap need (194 taps) while it steps about a
# source pixel per output pixel; its half-resolution re-plan accepts it,
# so a 2x-downscale tail took it once.
CURL = _camera(17, 45, -45, 0.0, (0.6, 0.8, 0.0))


def _plans(entries):
    """Camera plans at SIDE px; an entry (config, shrink) shrinks the
    plan's output that many times."""
    rng = np.random.default_rng(1)
    plans = []
    for entry in entries:
        config, shrink = entry if isinstance(entry, tuple) else (entry, 1)
        plan = D.camera_cubic_curve.plan(config, (SIDE, SIDE), rng)
        if shrink > 1:
            plan = rescale_plan_to(
                plan, tuple(s // shrink for s in plan.dst_shape))
        plans.append(plan)
    return plans


def _images(n):
    return torch.from_numpy(np.random.default_rng(2).random(
        (n, SIDE, SIDE, 5)).astype(np.float32) * 255)


def _nodes(plans):
    shapes, canvas = TB._batch_canvas(plans, _images(len(plans)), None)
    coarse_y, coarse_x, ys, xs = TB._build_coarse_nodes(
        plans, shapes, canvas)
    return coarse_y, coarse_x, ys, xs, canvas


def test_a_reject_at_ordinary_steps_is_one_the_half_plan_would_take():
    plans = _plans([MILD, CURL, MILD])
    coarse_y, coarse_x, ys, xs, canvas = _nodes(plans)
    boxes = TB._content_boxes(plans, range(len(plans)))
    planned = WB.plan_banded_warp(coarse_y, coarse_x, ys, xs, (SIDE, SIDE),
                                  canvas, content_boxes=boxes)
    assert list(planned[2]) == [1]
    assert planned[4][1] > 128
    halved = WB.plan_banded_warp(
        coarse_y[1:2] * 0.5 - 0.25, coarse_x[1:2] * 0.5 - 0.25, ys, xs,
        (SIDE // 2, SIDE // 2), canvas, content_boxes=boxes[1:2])
    assert halved is not None and len(halved[2]) == 0


# name -> (batch, the rejected sample's row): a tap need at about a pixel
# a step, a map that minifies fivefold, and one minified eightfold that
# the banded plan rejects even at half resolution.
REJECTS = {
    'ordinary-steps': ([MILD, CURL, MILD], 1),
    'minifies': ([MILD, (MILD, 5)], 1),
    'minifies-folded': ([MILD, (CURL, 8)], 1),
}


@pytest.mark.parametrize('name', sorted(REJECTS))
def test_every_reject_takes_the_gather_route(name):
    entries, row = REJECTS[name]
    plans = _plans(entries)
    images = _images(len(plans))
    with profiling.recording() as rec:
        out = TB.batched_plan_warp(plans, images)[0]
    served = {r: rec.counters.get(f'plan_warp.samples.{r}', 0)
              for r in ROUTES}
    assert served == dict(affine=0, banded=len(plans) - 1, half=0, gather=1)
    # The banded plan runs once: no re-plan of the rejects.
    assert [s.name for s in rec.spans].count('plan_warp.band_plan') == 1
    gathered = TB.batched_plan_warp(plans, images, mode='gather')[0]
    assert torch.equal(out[row], gathered[row])
