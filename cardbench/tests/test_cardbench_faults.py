"""The check that decides ``correct``, driven on the CPU at a size a test
run can hold: a sound run passes, the bfloat16 control fails a number,
and each fault the cell can have, planted where the program produces the
answer, turns ``correct`` false.  The rest of a run is the harness's own
(the look for a card is skipped); the card's kernels run their plain
versions here."""
import json
import time

import numpy as np
import pytest
import torch

from cardbench import harness

torch.set_num_threads(4)

CAMERA_SIDE = 320
CAMERA_SEED = 11


class SmallCell:
    def __init__(self, config: str, traffic: str, **changes):
        self.name = f'{config}.{traffic}.small'
        self.chips = 1
        self.config = dict(harness.load_json(
            harness.HERE / 'configs' / f'{config}.json'), **changes)
        self.traffic = json.loads(json.dumps(harness.load_json(
            harness.HERE / 'traffic' / f'{traffic}.json')))
        self.end_to_end = []
        self.per_layer = []


def camera_cell(traffic: str = 'camera'):
    return SmallCell('distort-640', traffic, side=CAMERA_SIDE, batch=4)


def drive(cell, seed, control=False):
    run = harness.Run(cell, seed, 0.01, False, time.time(), device='cpu')
    generator = harness.load_module(
        harness.HERE / 'generators' / f'{cell.traffic["generator"]}.py',
        f'cardbench_test_generator_{cell.traffic["generator"]}')
    generator.run(run, control=control)
    return run


def altered(module, name, change):
    """``module.name`` with ``change`` applied to what it returns."""
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        return change(original(*args, **kwargs))

    return wrapped


def shift_every_sample(out):
    """A tuple result whose first tensor is brighter by 40 throughout."""
    return (out[0] + 40.0,) + tuple(out[1:])


@pytest.mark.parametrize('traffic', ['camera', 'rotate'])
def test_distort_sound_run_is_correct_and_control_fails(traffic):
    run = drive(camera_cell(traffic), CAMERA_SEED, control=True)
    assert harness.correct(run), run.checks
    failed = [name for name, value in run.control.items()
              if value > run.checks[name]['limit']]
    assert failed, run.control


@pytest.mark.parametrize('traffic', ['camera', 'rotate'])
def test_distort_altered_warp_fails(monkeypatch, traffic):
    from vkit_tpu_torch.mechanism import batched

    monkeypatch.setattr(batched, 'batched_plan_warp', altered(
        batched, 'batched_plan_warp', shift_every_sample))
    run = drive(camera_cell(traffic), CAMERA_SEED)
    assert not run.checks['warp_lsb']['ok']
    assert not harness.correct(run)


def test_camera_altered_points_fail(monkeypatch):
    from vkit_tpu_torch.mechanism.distortion.warp_plan import WarpPlan

    original = WarpPlan.map_points

    def moved(self, np_xy):
        out = original(self, np_xy)
        out[0] += 10.0
        return out

    monkeypatch.setattr(WarpPlan, 'map_points', moved)
    run = drive(camera_cell(), CAMERA_SEED)
    assert not run.checks['points_px']['ok']
    assert not harness.correct(run)


def turned_further(config):
    return dict(config, angle=config['angle'] + 2)


def turned_the_other_way(config):
    return dict(config, angle=-config['angle'])


def camera_turned_further(config):
    camera = dict(config['camera_model_config'])
    camera['rotation_theta'] += 3
    return dict(config, camera_model_config=camera)


def curve_the_other_way(config):
    return dict(config, curve_alpha=-config['curve_alpha'],
                curve_beta=-config['curve_beta'])


@pytest.mark.parametrize('traffic, change', [
    ('rotate', turned_further), ('rotate', turned_the_other_way),
    ('camera', camera_turned_further), ('camera', curve_the_other_way)])
def test_distort_wrong_plan_fails(monkeypatch, traffic, change):
    """A planner that works out the wrong geometry from the config it was
    handed (the reference derives its own from the same config)."""
    from vkit_tpu_torch.mechanism import distortion

    name = harness.load_json(
        harness.HERE / 'traffic' / f'{traffic}.json')['params']['policy']
    target = getattr(distortion, name)
    original = target._plan_fn
    monkeypatch.setattr(target, '_plan_fn', lambda config, shape, rng:
                        original(type(config)(**attr_fields(change(
                            as_dict(config)))), shape, rng))
    run = drive(camera_cell(traffic), CAMERA_SEED)
    assert not harness.correct(run), run.checks


def as_dict(config):
    import attr

    return attr.asdict(config, recurse=True)


def attr_fields(fields):
    """The fields of a config class, the camera's own config rebuilt."""
    from vkit_tpu_torch.mechanism.distortion.geometric.camera import \
        CameraModelConfig

    if 'camera_model_config' in fields:
        fields = dict(fields, camera_model_config=CameraModelConfig(
            **fields['camera_model_config']))
    return fields


@pytest.mark.parametrize('policy, sides', [
    ('rotate', (640, 320)), ('camera_cubic_curve', (640, 320))])
def test_plain_geometry_agrees_with_the_planners(policy, sides):
    """At the cells' sizes the reference's geometry, worked out from the
    config alone, is the program's plan to rounding: the canvas equal, the
    matrix or every lattice node within 1e-4 px.  Rotations by multiples
    of 30 degrees are left out: there a shift is a whole number of pixels,
    which the planner's float rounding may push one further."""
    from vkit_tpu_torch.mechanism import distortion

    plain = harness.load_module(harness.HERE / 'policies' / f'{policy}.py',
                                f'cardbench_test_policy_{policy}')
    rng = np.random.default_rng(3)
    for side in sides:
        configs = ([{'angle': a} for a in range(-180, 181) if a % 30]
                   if policy == 'rotate' else
                   [plain.sample(level, (side, side), rng)
                    for level in (1, 5, 10) for _ in range(40)])
        for config in configs:
            geom = plain.geometry(config, (side, side))
            plan = getattr(distortion, policy).plan(config, (side, side))
            assert tuple(plan.dst_shape) == geom.dst_shape, config
            if plan.matrix is not None:
                gap = np.abs(np.asarray(plan.matrix, np.float64)
                             - geom.matrix[:2]).max()
            else:
                assert np.array_equal(plan.src_lattice, geom.src_lattice)
                gap = np.abs(plan.dst_lattice - geom.dst_lattice).max()
            assert gap < 1e-4, config


def test_a_run_without_checks_is_not_correct():
    run = harness.Run(camera_cell(), 1, 1.0, False, time.time(),
                      device='cpu')
    assert not harness.correct(run)
    run.check('warp_lsb', None)
    assert not harness.correct(run)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the cell runs on the card')
    return torch.device('cuda')


@pytest.mark.parametrize('name', ['distort-640.camera', 'distort-640.rotate'])
def test_distort_cell_on_the_card(cuda_device, name):
    """One short run of a distortion cell at its own size on the card."""
    bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')
    cell = harness.Cell(bench, name)
    run = harness.Run(cell, 5, 2.0, False, time.time())
    generator = harness.load_module(
        harness.HERE / 'generators' / 'grid_warp.py',
        'cardbench_test_grid_warp')
    generator.run(run)
    assert harness.correct(run), run.checks
    assert np.isfinite(run.end_to_end['images_per_s'])
