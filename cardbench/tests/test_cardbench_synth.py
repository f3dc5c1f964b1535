"""The synth cell's entries and its check, driven on the CPU at a size a
test run can hold: 2 pages of 256 x 256 a batch.  A sound run passes and
the bfloat16 control fails; each fault planted where the program produces
the answer (glyphs composited a pixel off their boxes, a crop cut a pixel
off its window, the region flatten turned the wrong way) turns ``correct``
false."""
import json
import time

import numpy as np
import pytest
import torch

from cardbench import harness

torch.set_num_threads(4)

CELL = 'synth-640.regions'
SEED = 11
METRICS = ('prep_wait_s.regions', 'assemble_s.regions',
           'photometric_s.regions', 'geometric_s.regions', 'region_s.regions',
           'idle_assemble.regions', 'idle_region.regions')


@pytest.fixture(scope='module')
def bench():
    return json.loads((harness.ROOT / 'BENCHMARK.json').read_text())


def test_the_cell_resolves_to_its_files(bench):
    cell = harness.Cell(bench, CELL)
    assert cell.config['side'] == 640 and cell.config['batch'] == 8
    assert cell.traffic['generator'] == 'synth_stream'
    assert set(cell.traffic['limits']) == {
        'assemble_pct', 'warp_lsb', 'crop_px', 'flatten_lsb', 'points_px'}
    config, = [c for c in bench['configs'] if c['name'] == 'synth-640']
    assert config['reduced'] == ['assets']
    assert 'assets' in cell.config
    assert (harness.ROOT / config['file']).is_file()
    assert (harness.HERE / 'generators' / 'synth_stream.py').is_file()
    assert {m['name'] for m in cell.end_to_end} == {'peak_mem_gib',
                                                     'setup_s'}
    assert {m['name'] for m in cell.per_layer} == set(METRICS)
    for name in METRICS:
        assert harness.reader_path(name).is_file()


class SmallCell:
    name = f'{CELL}.small'
    chips = 1
    end_to_end = []
    per_layer = []

    def __init__(self):
        self.config = dict(
            harness.load_json(harness.HERE / 'configs' / 'synth-640.json'),
            side=256, batch=2, crop_core=192, region_page=256,
            region_crop=128, target_char_height=24)
        self.traffic = harness.load_json(harness.HERE / 'traffic'
                                         / 'regions.json')


def drive(seed=SEED, control=False):
    run = harness.Run(SmallCell(), seed, 0.01, False, time.time(),
                      device='cpu')
    generator = harness.load_module(
        harness.HERE / 'generators' / 'synth_stream.py',
        'cardbench_test_generator_synth_stream')
    generator.run(run, control=control)
    return run


@pytest.fixture(scope='module')
def sound():
    return drive(control=True)


def test_sound_run_is_correct_and_the_control_fails(sound):
    assert harness.correct(sound), sound.checks
    assert sound.units >= 1 and sound.attempted == 2 * sound.units
    failed = [name for name, value in sound.control.items()
              if value > sound.checks[name]['limit']]
    assert set(failed) >= {'assemble_pct', 'warp_lsb', 'flatten_lsb',
                           'points_px'}, sound.control


def test_glyphs_off_their_boxes_fail(monkeypatch):
    from vkit_tpu_torch.synth import device

    original = device.pack_placements

    def shifted(*args, **kwargs):
        placements, tiles, out_tile = original(*args, **kwargs)
        return (placements._replace(lefts=placements.lefts + 1), tiles,
                out_tile)

    monkeypatch.setattr(device, 'pack_placements', shifted)
    run = drive()
    assert not run.checks['assemble_pct']['ok'], run.checks
    assert not harness.correct(run)


def test_a_crop_off_its_window_fails(monkeypatch):
    from vkit_tpu_torch.synth import device

    original = device._extract_crops_program

    def shifted(images, labels, active, sample_ids, ups, lefts, size):
        return original(images, labels, active, sample_ids, ups,
                        np.asarray(lefts) + 1, size)

    monkeypatch.setattr(device, '_extract_crops_program', shifted)
    run = drive()
    assert not run.checks['crop_px']['ok'], run.checks
    assert not harness.correct(run)


def test_a_flatten_turned_the_wrong_way_fails(monkeypatch):
    from vkit_tpu_torch.ops import region

    original = region.batch_flatten_regions

    def turned(patches, angles, *args, **kwargs):
        return original(patches, -np.asarray(angles), *args, **kwargs)

    monkeypatch.setattr(region, 'batch_flatten_regions', turned)
    run = drive()
    assert not run.checks['flatten_lsb']['ok'], run.checks
    assert not harness.correct(run)


def plant_reject(monkeypatch):
    """The full-resolution banded plan rejects the sample with the largest
    tap need (its taps_max one below that need), as a page that needs
    more than the ladder's 128 taps is rejected at the cell's size."""
    from vkit_tpu_torch.mechanism import batched

    original = batched.plan_banded_warp
    planted = []

    def plan(coarse_y, coarse_x, ys, xs, src_shape, dst_shape, **kwargs):
        out = original(coarse_y, coarse_x, ys, xs, src_shape, dst_shape,
                       **kwargs)
        if out is None or src_shape != (256, 256) or len(out[4]) < 2:
            return out
        needs = out[4]
        if needs.min() == needs.max():
            return out
        planted.append(int(np.argmax(needs)))
        return original(coarse_y, coarse_x, ys, xs, src_shape, dst_shape,
                        **dict(kwargs, taps_max=int(needs.max()) - 1))

    monkeypatch.setattr(batched, 'plan_banded_warp', plan)
    return planted


# A seed whose checked batch sends both pages to the banded plan.
ROUTING_SEED = 12


def test_a_reject_at_ordinary_steps_passes_by_the_gather_route(monkeypatch):
    planted = plant_reject(monkeypatch)
    run = drive(ROUTING_SEED)
    assert planted, 'no reject was planted'
    assert harness.correct(run), run.checks
