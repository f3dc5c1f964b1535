"""The port's program spans and counters (vkit_tpu_torch/utility/profiling.py)
and where ``batched_plan_warp`` records them, on the CPU.

A ``Recording`` is a ``StepTimer`` that also keeps each span with its id,
its parent's id, the id of the top-level span it runs under and its
thread, and named counters; ``span`` and ``count`` write to the active
recording and do nothing without one.  ``batched_plan_warp`` marks its
host phases and counts the samples each route served.
"""
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.mechanism import distortion as D
from vkit_tpu_torch.utility import profiling
from vkit_tpu_torch.utility.profiling import Recording, StepTimer

SIDE = 128
CHILDREN = {'plan_warp.route', 'plan_warp.nodes', 'plan_warp.band_plan',
            'plan_warp.enqueue'}
ROUTES = ('affine', 'banded', 'half', 'gather')
NODE_COUNTERS = ('native', 'fullres')


def test_off_path_records_nothing():
    before = profiling.last_recording()
    first, second = profiling.span('a'), profiling.span('b')
    assert first is second
    with first:
        with profiling.span('c'):
            profiling.count('n', 3)
    assert profiling.last_recording() is before


def test_a_recording_is_a_step_timer_with_spans_and_counters():
    with profiling.recording() as rec:
        assert isinstance(rec, StepTimer)
        with profiling.span('outer'):
            with profiling.span('inner'):
                pass
            with profiling.span('inner'):
                pass
        profiling.count('things')
        profiling.count('things', 4)
    assert profiling.last_recording() is rec
    assert rec.summary()['inner']['count'] == 2
    assert rec.counters == {'things': 5}
    assert [s.name for s in rec.spans] == ['inner', 'inner', 'outer']
    with profiling.span('after'):
        pass
    assert len(rec.spans) == 3


def test_one_recording_at_a_time():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass


def _self_seconds(spans, span):
    return (span.end - span.begin) - sum(
        s.end - s.begin for s in spans if s.parent == span.span_id)


def test_ids_parents_and_requests_on_two_threads():
    """Each thread nests its own spans; a top-level span's id is the
    request of every span under it; totals are the spans' durations and
    self time is a span's duration less its children's."""
    both = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.span(f'{tag}.top'):
            both.wait()
            with profiling.span(f'{tag}.mid'):
                with profiling.span(f'{tag}.leaf'):
                    both.wait()
            with profiling.span(f'{tag}.leaf'):
                pass

    with profiling.recording() as rec:
        other = threading.Thread(target=work, args=('b',))
        other.start()
        work('a')
        other.join(timeout=10)
        assert not other.is_alive()

    spans = {(s.name, s.span_id): s for s in rec.spans}
    assert len(spans) == 8 and len({s.span_id for s in rec.spans}) == 8
    by_id = {s.span_id: s for s in rec.spans}
    for tag in 'ab':
        mine = [s for s in rec.spans if s.name.startswith(tag)]
        top, = [s for s in mine if s.name.endswith('.top')]
        mid, = [s for s in mine if s.name.endswith('.mid')]
        leaves = [s for s in mine if s.name.endswith('.leaf')]
        assert len({s.thread for s in mine}) == 1
        assert top.parent is None and top.request == top.span_id
        assert mid.parent == top.span_id
        assert sorted(leaf.parent for leaf in leaves) == sorted(
            [top.span_id, mid.span_id])
        for s in mine:
            assert s.request == top.span_id
            if s.parent is not None:
                parent = by_id[s.parent]
                assert parent.begin <= s.begin <= s.end <= parent.end
        assert rec.totals[f'{tag}.leaf'] == pytest.approx(
            sum(leaf.end - leaf.begin for leaf in leaves))
        assert 0 <= _self_seconds(rec.spans, top) <= top.end - top.begin
        assert _self_seconds(rec.spans, mid) == pytest.approx(
            (mid.end - mid.begin) - sum(leaf.end - leaf.begin for leaf in
                                        leaves if leaf.parent == mid.span_id))
    threads = {s.thread for s in rec.spans}
    assert len(threads) == 2


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, 'SPAN_LIMIT', 3)
    rec = Recording()
    for _ in range(5):
        with rec.measure('s'):
            pass
    assert len(rec.spans) == 3 and rec.dropped == 2
    assert rec.counts['s'] == 5


def test_device_trace_leaves_its_recording(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.span('inside'):
            pass
    rec = profiling.last_recording()
    assert isinstance(rec, Recording)
    assert [s.name for s in rec.spans] == ['inside']
    with profiling.recording() as outer:
        with profiling.device_trace(str(tmp_path / 'again')):
            with profiling.span('traced'):
                pass
    assert profiling.last_recording() is outer
    assert [s.name for s in outer.spans] == ['traced']
    with profiling.device_trace(str(tmp_path / 'off'), enabled=False):
        with profiling.span('untraced'):
            pass
    assert profiling.last_recording() is outer


def test_the_clock_pair_places_a_span_on_the_trace(tmp_path):
    """A span that wraps a ``record_function`` region holds the region's
    ``ts`` in the exported Chrome trace, within 1 ms."""
    x = torch.ones(256)
    with profiling.device_trace(str(tmp_path)):
        with profiling.span('outer'):
            with record_function('region'):
                for _ in range(50):
                    x = x * 1.0001
    rec = profiling.last_recording()
    outer, = rec.spans
    trace, = tmp_path.glob('*.json')
    doc = json.loads(trace.read_text())
    region, = [e for e in doc['traceEvents'] if e.get('name') == 'region'
               and e.get('ph') == 'X']
    base = doc['baseTimeNanoseconds']
    begin = rec.trace_us(outer.begin, base)
    end = rec.trace_us(outer.end, base)
    assert begin - 1000 <= float(region['ts']) <= end + 1000
    assert float(region['ts']) + float(region['dur']) <= end + 1000


# ---------------------------------------------------------------------------
# batched_plan_warp's spans and route counters.
# ---------------------------------------------------------------------------


def _camera(theta, alpha, beta, direction, vec):
    return {
        'curve_alpha': alpha, 'curve_beta': beta,
        'curve_direction': direction, 'curve_scale': 1.0,
        'camera_model_config': {'rotation_unit_vec': list(vec),
                                'rotation_theta': theta},
        'grid_size': 15,
    }


MILD = _camera(2, -4, -4, 0.0, (1.0, 0.0, 0.0))
# Beside MILD at 128 px, the banded plan rejects these two, and the gather
# route takes them.
HALF = _camera(17, 45, -45, 0.0, (0.6, 0.8, 0.0))
GATHER = _camera(-8, 45, -45, 135.0, (1.0, 0.0, 0.0))

# name -> (camera configs, rotate configs, mode, samples each route serves)
BATCHES = {
    'camera-banded': ([MILD, MILD], [], 'auto', dict(banded=2)),
    'camera-half': ([MILD, HALF], [], 'auto', dict(banded=1, gather=1)),
    'camera-gather': ([MILD, GATHER], [], 'auto', dict(banded=1, gather=1)),
    'camera-forced-gather': ([MILD, HALF], [], 'gather', dict(gather=2)),
    'rotate': ([], [{'angle': 17.0}, {'angle': -80.0}, {'angle': 101.0}],
               'auto', dict(affine=3)),
    # The lattice rest pads to a bucket of 8: the padding rows count for
    # no route.  (The turned pages widen the canvas, and GATHER fits the
    # banded plan there.)
    'mixed': ([MILD, GATHER], [{'angle': 17.0 + 9 * i} for i in range(7)],
              'auto', dict(affine=7, banded=2)),
}


def _batch(cameras, rotates):
    rng = np.random.default_rng(1)
    plans = ([D.camera_cubic_curve.plan(c, (SIDE, SIDE), rng)
              for c in cameras]
             + [D.rotate.plan(c, (SIDE, SIDE), rng) for c in rotates])
    images = torch.from_numpy(np.random.default_rng(2).random(
        (len(plans), SIDE, SIDE, 5)).astype(np.float32) * 255)
    return plans, images


@pytest.mark.parametrize('name', sorted(BATCHES))
def test_plan_warp_spans_and_route_counters(name):
    cameras, rotates, mode, routes = BATCHES[name]
    plans, images = _batch(cameras, rotates)
    plain = TB.batched_plan_warp(plans, images, mode=mode, return_maps=True)
    with profiling.recording() as rec:
        traced = TB.batched_plan_warp(plans, images, mode=mode,
                                      return_maps=True)
    assert torch.equal(plain[0], traced[0])
    assert plain[1] == traced[1]
    if plain[3] is None:
        assert traced[3] is None
    else:
        for want, got in zip(plain[3], traced[3]):
            assert torch.equal(want, got)

    step, = [s for s in rec.spans if s.name == 'plan_warp']
    assert step.parent is None
    children = [s for s in rec.spans if s is not step]
    assert all(s.parent == step.span_id and s.request == step.span_id
               for s in children)
    names = {s.name for s in children}
    assert names <= CHILDREN
    assert 'plan_warp.enqueue' in names
    if cameras:
        assert 'plan_warp.nodes' in names
    if mode == 'auto':
        assert 'plan_warp.route' in names
    if cameras and mode == 'auto':
        assert 'plan_warp.band_plan' in names
    if not cameras:
        assert not names & {'plan_warp.nodes', 'plan_warp.band_plan'}

    served = {r: rec.counters.get(f'plan_warp.samples.{r}', 0)
              for r in ROUTES}
    assert served == {r: routes.get(r, 0) for r in ROUTES}
    assert sum(served.values()) == len(plans)
    # Every lattice sample's node maps come from the native node pass.
    nodes = {k: rec.counters.get(f'plan_warp.nodes.{k}', 0)
             for k in NODE_COUNTERS}
    assert nodes == dict(native=len(cameras), fullres=0)
    assert set(rec.counters) <= (
        {f'plan_warp.samples.{r}' for r in ROUTES}
        | {f'plan_warp.nodes.{k}' for k in NODE_COUNTERS})


def test_dense_mode_records_nothing():
    plans, images = _batch([MILD], [{'angle': 9.0}])
    with profiling.recording() as rec:
        TB.batched_plan_warp(plans, images, mode='dense')
    assert rec.spans == [] and not rec.counters


# ---------------------------------------------------------------------------
# The synthesis program's spans and counters.
# ---------------------------------------------------------------------------

SYNTH_STAGES = {
    'assemble', 'photometric', 'plan-host', 'warp', 'active-host', 'finish',
    'polygons-host', 'char-gaussians', 'crops', 'region',
    'region.collect-host', 'region.gather+flatten', 'region.composite',
    'region.gaussians', 'region.regression-host', 'fetch',
}


@pytest.fixture(scope='module')
def synth_planner(tmp_path_factory):
    from vkit_tpu_torch.synth import assets as A

    root = tmp_path_factory.mktemp('profiling_synth_assets')
    assets = A.build_assets(root, A.find_font(root))
    return A.make_planner(assets, 256)


def _synth_options():
    from vkit_tpu_torch.synth import CropConfig, RegionStreamConfig

    return dict(
        crop_config=CropConfig(core_size=192, num_per_page=2),
        emit_char_gaussians=True,
        region_config=RegionStreamConfig(page_size=256,
                                         target_char_height=24,
                                         num_crops_per_page=2,
                                         crop_size=128),
        device='cpu',
    )


def test_synth_spans_and_counters(synth_planner, monkeypatch):
    from vkit_tpu_torch.synth import synthesize_page_batch

    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda *a, **k: synced.append(a))
    pages = synth_planner.prepare_batch(1, np.random.default_rng(14))
    before = profiling.last_recording()
    plain = synthesize_page_batch(pages, 5, np.random.default_rng(15),
                                  **_synth_options())
    assert profiling.last_recording() is before
    with profiling.recording() as rec:
        traced = synthesize_page_batch(pages, 5, np.random.default_rng(15),
                                       **_synth_options())
    assert synced == []
    np.testing.assert_array_equal(traced.images, plain.images)
    np.testing.assert_array_equal(traced.crop_images, plain.crop_images)
    np.testing.assert_array_equal(traced.text_regions.images,
                                  plain.text_regions.images)

    synth = [s for s in rec.spans if s.name.startswith('synth.')]
    assert {s.name for s in synth} == {f'synth.{n}' for n in SYNTH_STAGES}
    by_id = {s.span_id: s for s in rec.spans}
    for s in synth:
        parent = by_id.get(s.parent)
        if s.name.startswith('synth.region.'):
            assert parent.name == 'synth.region'
        else:
            assert s.parent is None
    # The warp's own spans run under synth.warp.
    step, = [s for s in rec.spans if s.name == 'plan_warp']
    assert by_id[step.parent].name == 'synth.warp'

    regions = traced.text_regions
    assert regions.num_pages >= 1 and regions.num_crops >= 1
    assert traced.num_crops >= 1
    counted = {k: v for k, v in rec.counters.items()
               if k.startswith('synth.')}
    assert counted == {
        'synth.pages': len(pages),
        'synth.crops': traced.num_crops,
        'synth.region_pages': regions.num_pages,
        'synth.region_crops': regions.num_crops,
        'synth.regions': sum(len(b) for b in regions.region_boxes),
    }


def test_synth_stream_spans_the_prep_and_its_wait(synth_planner):
    from vkit_tpu_torch.synth import synthesize_stream

    with profiling.recording() as rec:
        results = list(synthesize_stream(
            synth_planner, 1, 5, np.random.default_rng(3), num_batches=2,
            device='cpu'))
    assert len(results) == 2
    main = threading.get_ident()
    waits = [s for s in rec.spans if s.name == 'synth.prep_wait']
    preps = [s for s in rec.spans if s.name == 'synth.prep']
    # One wait a batch and one for the end of the stream.
    assert len(waits) == 3 and all(s.thread == main for s in waits)
    assert len(preps) == 2 and all(s.thread != main for s in preps)
    assert all(s.parent is None for s in waits + preps)
    assert rec.counters['synth.pages'] == 2
