"""The coarse node maps of lattice plans (``_lattice_node_pass``,
vkit_tpu_torch/native/node_maps.cpp), bit for bit: before the repair against
geometry.cpp's rasterising ``vg_lattice_node_maps``, and after it, through
``_build_coarse_nodes``, against vkit_tpu's.  Inputs: the benchmark's camera
batch (32 camera_cubic_curve plans at 640², level 5), small canvases whose
cells are larger than the 8-px node spacing, the other lattice policies, a
batch mixing affine and lattice plans with dst shapes smaller than the
canvas, and hand-built lattices (a collapsed cell row, quads partly outside
the canvas, nodes on a cell's outline, node rows with interior gaps and an
interior row with no coverage).  Then the routing counters and the
full-resolution fallback without the native library."""
import ctypes

import numpy as np
import pytest

import vkit_tpu.native
import vkit_tpu_torch.native
from tests.test_torch_host import assert_same_plans, assert_same_value
from vkit_tpu.mechanism import batched as JB
from vkit_tpu.mechanism.distortion.warp_plan import WarpPlan as JaxWarpPlan
from vkit_tpu.mechanism.distortion_policy.geometric import affine as JA
from vkit_tpu.mechanism.distortion_policy.geometric import camera as JC
from vkit_tpu.mechanism.distortion_policy.geometric import mls as JM
from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.mechanism.distortion.warp_plan import (
    WarpPlan,
    uniform_lattice,
)
from vkit_tpu_torch.mechanism.distortion_policy.geometric import affine as TA
from vkit_tpu_torch.mechanism.distortion_policy.geometric import camera as TC
from vkit_tpu_torch.mechanism.distortion_policy.geometric import mls as TM
from vkit_tpu_torch.utility import profiling

POLICIES = {
    'camera_cubic_curve': (JC.camera_cubic_curve_policy_factory,
                           TC.camera_cubic_curve_policy_factory),
    'camera_plane_only': (JC.camera_plane_only_policy_factory,
                          TC.camera_plane_only_policy_factory),
    'similarity_mls': (JM.similarity_mls_policy_factory,
                       TM.similarity_mls_policy_factory),
    'rotate': (JA.rotate_policy_factory, TA.rotate_policy_factory),
}

# The hand-built lattices' canvas: with 8-px nodes its nodes lie on every
# multiple of 8, so the lattices below place edges and vertices on them.
HAND_CANVAS = (65, 65)


def _policy_plans(draws, seed):
    """((policy, shape), ...) drawn and planned by each package from one
    seed: (vkit_tpu's plans, the port's), checked equal."""
    ref_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    ref, got = [], []
    for name, shape in draws:
        ref_factory, factory = POLICIES[name]
        ref_policy, policy = ref_factory.create(), factory.create()
        ref.append(ref_policy.distortion.plan(
            ref_policy.sample_config(5, shape, ref_rng), shape, ref_rng))
        got.append(policy.distortion.plan(
            policy.sample_config(5, shape, rng), shape, rng))
    assert_same_plans(ref, got)
    return ref, got


def _hand_lattices():
    """(dst lattice (R, C, 2) xy, src grid size) of each hand-built plan on
    HAND_CANVAS."""
    grid = uniform_lattice(65, 65, 16)
    # A row of zero-area cells at the top (its two lattice rows coincide)
    # and one in the middle, on the node row y = 16.
    collapsed = grid.copy()
    collapsed[1, :, 1] = 0.0
    collapsed[2, :, 1] = 16.0
    # Sheared by the row: the cells' slanted edges pass through node
    # pixels ((8, 8) lies on the edge from (0, 0) to (16, 16)), and the
    # right half of the lattice lies outside the canvas.
    sheared = grid.copy()
    sheared[..., 0] += grid[..., 1]
    # A crown: the top edge dips to y = 16 at x = 16 and 48, so the node
    # row y = 8 is covered, then not, then covered again; the lattice
    # starts at y = 4, so the node row y = 0 has no coverage.
    crown = grid.copy()
    crown[0, :, 1] = [4.0, 16.0, 4.0, 16.0, 4.0]
    # An hourglass whose neck (x 26-30 on the node row y = 48) holds no
    # node: an interior node row with no coverage, nearer the bottom row.
    neck = uniform_lattice(65, 65, 32)
    neck[1, :, 0] = [26.0, 28.0, 30.0]
    neck[1, :, 1] = 48.0
    return [(collapsed, 16), (sheared, 16), (crown, 16), (neck, 32)]


def _hand_plans():
    ref, got = [], []
    for dst, grid_size in _hand_lattices():
        src = uniform_lattice(65, 65, grid_size)
        for plans, cls in ((ref, JaxWarpPlan), (got, WarpPlan)):
            plans.append(cls(src_shape=HAND_CANVAS, dst_shape=HAND_CANVAS,
                             src_lattice=src.copy(), dst_lattice=dst.copy(),
                             grid_size=grid_size))
    return ref, got


def _camera(n, side):
    return [('camera_cubic_curve', (side, side))] * n


# id -> (plans of both packages, node_step); the canvas is the largest dst.
CASES = {
    # The benchmark's camera batch: 16-px nodes, 15-px cells.
    'camera-640': (lambda: _policy_plans(_camera(32, 640), 0), None),
    # Canvases under 320 px take 8-px nodes: cells larger than the spacing.
    'camera-256': (lambda: _policy_plans(_camera(8, 256), 1), None),
    'camera-320-8px': (lambda: _policy_plans(_camera(8, 320), 2), 8),
    'camera_plane_only': (
        lambda: _policy_plans([('camera_plane_only', (640, 640))] * 8, 3),
        None),
    'similarity_mls': (
        lambda: _policy_plans([('similarity_mls', (640, 640))] * 8, 4),
        None),
    # Affine and lattice plans together, most dst shapes under the canvas.
    'mixed': (lambda: _policy_plans([
        ('rotate', (320, 320)), ('camera_cubic_curve', (256, 256)),
        ('similarity_mls', (320, 320)), ('rotate', (256, 256)),
        ('camera_plane_only', (320, 320)), ('camera_cubic_curve', (320, 320)),
    ], 5), None),
    'hand-built': (_hand_plans, 8),
}


def _canvas(plans):
    shapes = [p.dst_shape for p in plans]
    return shapes, (max(s[0] for s in shapes), max(s[1] for s in shapes))


def _rasterised(lib, plan, ys, xs):
    """geometry.cpp's vg_lattice_node_maps for one plan: (cy, cx, covered)
    before the repair."""
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    inv = np.ascontiguousarray(plan._cell_mats(inverse=True), np.float64)
    quads = np.ascontiguousarray(plan._quads('dst'), np.float64)
    ys32 = np.ascontiguousarray(ys, np.int32)
    xs32 = np.ascontiguousarray(xs, np.int32)
    cy = np.zeros((len(ys), len(xs)), np.float32)
    cx = np.zeros_like(cy)
    cov = np.zeros(cy.shape, np.uint8)
    lib.vg_lattice_node_maps(
        quads.ctypes.data_as(f64p), inv.ctypes.data_as(f64p), len(quads),
        *plan.dst_shape, ys32.ctypes.data_as(i32p), len(ys32),
        xs32.ctypes.data_as(i32p), len(xs32), cy.ctypes.data_as(f32p),
        cx.ctypes.data_as(f32p), cov.ctypes.data_as(u8p),
    )
    return cy, cx, cov


def _assert_hand_cases_bite(cov, ys, xs):
    """The hand-built lattices hold what they were built for."""
    collapsed, sheared, crown, neck = cov.astype(bool)
    row = {int(y): i for i, y in enumerate(ys)}
    col = {int(x): i for i, x in enumerate(xs)}
    # The collapsed middle row's nodes lie on zero-area cells' outlines.
    assert collapsed[row[16]].all()
    # Nodes on a slanted edge; the canvas cuts the sheared lattice.
    assert sheared[row[8], col[8]] and not sheared[row[8], col[0]]
    assert sheared[row[64]].sum() == 1
    # The crown: an uncovered top row, a row with interior gaps.
    assert not crown[row[0]].any()
    gaps = crown[row[8]]
    assert gaps[col[0]] and not gaps[col[16]] and gaps[col[32]]
    # The neck: an interior row with no coverage.
    assert neck[row[40]].any() and neck[row[56]].any()
    assert not neck[row[48]].any()


@pytest.mark.parametrize('case', list(CASES))
def test_node_pass_matches_the_rasteriser(case):
    """Coverage and values before the repair equal geometry.cpp's
    rasterising pass, node for node."""
    lib = vkit_tpu_torch.native.load_library()
    assert lib is not None
    make, node_step = CASES[case]
    _, plans = make()
    lattice = [p for p in plans if p.is_lattice]
    shapes, canvas = _canvas(plans)
    ys, xs = TB._build_coarse_nodes(plans, shapes, canvas, node_step)[2:]
    n = len(lattice)
    cy = np.full((n + 1, len(ys), len(xs)), np.nan, np.float32)
    cx = np.full_like(cy, np.nan)
    cov = np.empty((n, len(ys), len(xs)), np.uint8)
    # Rows in reverse, the first left alone.
    assert TB._lattice_node_pass(lattice, np.arange(n, 0, -1), ys, xs,
                                 cy, cx, repair=False, covered=cov)
    assert np.isnan(cy[0]).all() and np.isnan(cx[0]).all()
    for i, plan in enumerate(lattice):
        ref_y, ref_x, ref_cov = _rasterised(lib, plan, ys, xs)
        np.testing.assert_array_equal(cov[i], ref_cov, err_msg=f'{case} {i}')
        np.testing.assert_array_equal(cy[n - i], ref_y, err_msg=f'{case} {i}')
        np.testing.assert_array_equal(cx[n - i], ref_x, err_msg=f'{case} {i}')
    if case == 'hand-built':
        _assert_hand_cases_bite(cov, ys, xs)


@pytest.mark.parametrize('case', list(CASES))
def test_coarse_nodes_match_the_reference(case):
    """``_build_coarse_nodes`` (the node pass and its repair) equals
    vkit_tpu's, which rasterises each cell and repairs in numpy."""
    make, node_step = CASES[case]
    ref_plans, plans = make()
    shapes, canvas = _canvas(plans)
    ref = JB._build_coarse_nodes(ref_plans, shapes, canvas, node_step)
    got = TB._build_coarse_nodes(plans, shapes, canvas, node_step)
    assert_same_value(list(ref), list(got), f'{case} nodes')
    # The single-plan form gives the same rows.
    for i, plan in enumerate(plans):
        if plan.is_lattice:
            cy, cx = TB.lattice_node_maps(plan, got[2], got[3])
            np.testing.assert_array_equal(cy, got[0][i])
            np.testing.assert_array_equal(cx, got[1][i])


def test_node_counters():
    """Every lattice sample counts under ``plan_warp.nodes.native``; affine
    samples and full-resolution tuples count under neither."""
    _, plans = CASES['mixed'][0]()
    shapes, canvas = _canvas(plans)
    n_lattice = sum(p.is_lattice for p in plans)
    assert 0 < n_lattice < len(plans)
    full = TB.plan_backward_maps(plans[1], plans[1].src_shape)[:2]
    with profiling.recording() as rec:
        TB._build_coarse_nodes(plans, shapes, canvas)
        TB._build_coarse_nodes([full, plans[0]], shapes[1:2] + shapes[:1],
                               canvas)
    assert rec.counters['plan_warp.nodes.native'] == n_lattice
    assert rec.counters['plan_warp.nodes.fullres'] == 0


def test_fallback_without_the_library(monkeypatch):
    """Without the native library each lattice sample takes its
    full-resolution maps, as vkit_tpu's does without its own, and counts
    under ``plan_warp.nodes.fullres``."""
    draws = [('camera_cubic_curve', (256, 256)), ('rotate', (256, 256)),
             ('similarity_mls', (256, 256))]
    ref_plans, plans = _policy_plans(draws, 6)
    ref_hand, hand = _hand_plans()
    ref_plans, plans = ref_plans + ref_hand[-1:], plans + hand[-1:]
    monkeypatch.setattr(vkit_tpu.native, 'load_library', lambda: None)
    monkeypatch.setattr(vkit_tpu_torch.native, 'load_library', lambda: None)
    shapes, canvas = _canvas(plans)
    ref = JB._build_coarse_nodes(ref_plans, shapes, canvas)
    with profiling.recording() as rec:
        got = TB._build_coarse_nodes(plans, shapes, canvas)
    assert_same_value(list(ref), list(got), 'fallback nodes')
    assert rec.counters['plan_warp.nodes.fullres'] == 3
    assert rec.counters['plan_warp.nodes.native'] == 0
    assert TB.lattice_node_maps(plans[0], got[2], got[3]) is None
