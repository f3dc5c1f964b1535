"""The port's 17-step text-detection pipeline (vkit_tpu_torch/pipeline/)
against vkit_tpu's, step by step from one seed, at the repo's own
configuration of it (tests/pipeline/fixtures.py: 640 x 640 pages).  Both
packages build their steps over the same assets; the port's step 15
flattens its text regions with ``device='cpu'``, where the row-shift
wrappers take their plain versions, and the reference's runs its two-shear
program through XLA on the CPU.  After each step both rngs must be in the
same state, then the outputs must agree.

Tolerances.  Every host field (shapes, boxes, polygons, labels, angles,
counts) is equal.  The rasters of steps 15-17 (the stacked page of
flattened text regions, its active mask, and their crops) come out of the
flatten's float32 warp, which XLA and PyTorch round differently, and its
alpha threshold at 0.5 turns a last-bit difference into a whole pixel on a
region outline (tests/test_torch_region.py): they are held to 1 LSB (images)
or 1e-5 (score maps) but for EDGE_SHARE of their pixels.  Every other
raster is equal.

tests/test_torch_pipeline_seeds.py holds the other seeds, and the helpers
here serve it.
"""
import enum

import attr
import numpy as np
import pytest
import torch

from tests.pipeline.fixtures import build_assets
from tests.pipeline.fixtures import build_step_configs as reference_configs
from tests.test_torch_kdtree import tied_rows
from tests.test_torch_region import EDGE_SHARE
from vkit_tpu import pipeline as jax_pipeline
from vkit_tpu.element import Image as JaxImage
from vkit_tpu.element import Polygon as JaxPolygon
from vkit_tpu.pipeline.text_detection import page_text_region as JTR
from vkit_tpu_torch import convert
from vkit_tpu_torch import pipeline as torch_pipeline
from vkit_tpu_torch.element import Image, Polygon
from vkit_tpu_torch.pipeline.text_detection import page_text_region as TTR
from vkit_tpu_torch.pipeline.text_detection import (
    page_text_region_label as TTRL,
)
from vkit_tpu_torch.synth.assets import build_step_configs
from vkit_tpu_torch.utility.kdtree import KDTree

torch.set_num_threads(1)

# The steps whose rasters come out of step 15's batched flatten.
FLATTENED_STEPS = ('PageTextRegionStep', 'PageTextRegionLabelStep',
                   'PageTextRegionCroppingStep')


# ---------------------------------------------------------------------------
# Helpers shared with tests/test_torch_pipeline_seeds.py.
# ---------------------------------------------------------------------------


def leaves(value, path='', out=None, seen=frozenset()):
    """Path -> leaf of a step output of either package: numpy arrays and
    scalars as they are, and each object's class name under ``path:type``.
    Public attrs fields and slots are walked; private ones (lazy caches)
    are not."""
    out = {} if out is None else out
    if value is None or isinstance(value, (bool, int, float, str,
                                           np.generic)):
        out[path] = value
        return out
    if isinstance(value, enum.Enum):
        out[path] = (type(value).__name__, value.name, value.value)
        return out
    if isinstance(value, np.ndarray):
        out[path] = value
        return out
    assert id(value) not in seen, f'a cycle at {path}'
    seen = seen | {id(value)}
    out[path + ':type'] = type(value).__name__
    if attr.has(type(value)):
        names = [f.name for f in attr.fields(type(value))]
    elif isinstance(value, dict):
        for key in value:
            leaves(value[key], f'{path}[{key!r}]', out, seen)
        return out
    elif isinstance(value, (list, tuple)):
        out[path + ':len'] = len(value)
        for i, item in enumerate(value):
            leaves(item, f'{path}[{i}]', out, seen)
        return out
    else:
        names = [s for c in type(value).__mro__
                 for s in getattr(c, '__slots__', ())]
        names += list(getattr(value, '__dict__', {}))
    names = [n for n in names if not n.startswith('_')]
    assert names, f'nothing to compare in {type(value).__name__} at {path}'
    for name in names:
        leaves(getattr(value, name), f'{path}.{name}', out, seen)
    return out


def _assert_raster_close(path, kind, ref, got):
    if kind == 'Image':
        off = np.abs(ref.astype(np.int64) - got.astype(np.int64)) > 1
    elif kind == 'ScoreMap':
        off = np.abs(ref - got) > 1e-5
    else:
        off = ref != got
    assert off.sum() <= EDGE_SHARE * off.size, (path, int(off.sum()),
                                                off.size)


def assert_same_output(ref, got, where, flattened=False):
    """Equal step outputs; with ``flattened``, rasters within the
    tolerance of the module docstring.  Returns the number of raster
    elements that differ."""
    ref_leaves, got_leaves = leaves(ref, where), leaves(got, where)
    assert ref_leaves.keys() == got_leaves.keys(), sorted(
        ref_leaves.keys() ^ got_leaves.keys())[:10]
    differ = 0
    for path, a in ref_leaves.items():
        b = got_leaves[path]
        if not (isinstance(a, np.ndarray) or isinstance(b, np.ndarray)):
            assert a == b or (a != a and b != b), (path, a, b)
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (
            path, a.shape, b.shape, a.dtype, b.dtype)
        if np.array_equal(a, b):
            continue
        kind = ref_leaves.get(path[:-len('.mat')] + ':type')
        assert flattened and path.endswith('.mat') and kind in (
            'Image', 'Mask', 'ScoreMap'), path
        _assert_raster_close(path, kind, a, b)
        differ += int((a != b).sum())
    return differ


@pytest.fixture(scope='module')
def pipeline_assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp('torch_pipeline_assets'))


@pytest.fixture(scope='module')
def step_pair(pipeline_assets):
    """(vkit_tpu's 17 steps, the port's) over the same assets; the port's
    step 15 on the CPU."""
    ref = jax_pipeline.pipeline_step_collection_factory.create(
        reference_configs(pipeline_assets))
    got = torch_pipeline.pipeline_step_collection_factory.create(
        build_step_configs(pipeline_assets, device='cpu'))
    return ref, got


def run_step_pair(step_pair, seed):
    """Both packages' steps in turn from ``seed``, as Pipeline.run runs
    them; after each step, both rngs in the same state.  Yields (step
    name, reference output, port output); an exception of a step is
    raised by both, with the same message, and re-raised."""
    ref_steps, got_steps = step_pair
    ref_rng, got_rng = (np.random.default_rng(seed) for _ in range(2))
    ref_state = jax_pipeline.PipelineState()
    got_state = torch_pipeline.PipelineState()
    for ref_step, got_step in zip(ref_steps, got_steps):
        name = type(got_step).__name__
        assert type(ref_step).__name__ == name
        ref_error = got_error = None
        try:
            ref_out = ref_step.run(
                ref_state.assemble(ref_step.get_input_cls()), ref_rng)
        except Exception as error:
            ref_error = error
        try:
            got_out = got_step.run(
                got_state.assemble(got_step.get_input_cls()), got_rng)
        except Exception as error:
            got_error = error
        if ref_error or got_error:
            assert (type(ref_error), str(ref_error)) == (
                type(got_error), str(got_error)), name
            raise got_error
        assert ref_rng.bit_generator.state == got_rng.bit_generator.state, (
            f'the rngs part after {name}')
        ref_state.store_output(ref_out)
        got_state.store_output(got_out)
        yield name, ref_out, got_out


@pytest.fixture
def kd_queries(monkeypatch):
    """Every query of the port's KD-trees in steps 15 and 16, recorded as
    (indexed points, query points, k, answer)."""
    records = []

    class RecordingKDTree(KDTree):

        def __init__(self, points):
            super().__init__(points)
            self.points = np.asarray(points)

        def query(self, points, k=1):
            answer = super().query(points, k)
            records.append((self.points, np.asarray(points), k, answer))
            return answer

    monkeypatch.setattr(TTR, 'KDTree', RecordingKDTree)
    monkeypatch.setattr(TTRL, 'KDTree', RecordingKDTree)
    return records


def assert_kd_queries_are_sklearns(records):
    """Each recorded answer is sklearn's (the reference's tree); returns
    (query rows, rows with a tie among their k nearest, rows that
    scipy's cKDTree answers otherwise)."""
    from scipy.spatial import cKDTree
    from sklearn.neighbors import KDTree as SklearnKDTree

    rows = tied = scipy_differ = 0
    for points, queries, k, (dist, ind) in records:
        ref_dist, ref_ind = SklearnKDTree(points).query(queries, k=k)
        np.testing.assert_array_equal(ind, ref_ind)
        np.testing.assert_array_equal(dist, ref_dist)
        rows += len(queries)
        tied += tied_rows(points, queries, k)
        _, scipy_ind = cKDTree(points).query(queries, k=k)
        scipy_differ += int((np.reshape(scipy_ind, ind.shape) != ind)
                            .any(axis=1).sum())
    return rows, tied, scipy_differ


def assert_pipeline_matches(step_pair, seed):
    """Every step output equal (module docstring); returns the count of
    raster elements that differ, by step."""
    differ = {}
    names = []
    for name, ref_out, got_out in run_step_pair(step_pair, seed):
        names.append(name)
        differ[name] = assert_same_output(
            ref_out, got_out, name, flattened=name in FLATTENED_STEPS)
    assert len(names) == 17
    for name in differ:
        if name not in FLATTENED_STEPS:
            assert differ[name] == 0
    return differ


# ---------------------------------------------------------------------------
# The registry and the step configs.
# ---------------------------------------------------------------------------


def test_registry_is_the_references():
    ref = jax_pipeline.pipeline_step_collection_factory.name_to_step_factory
    got = torch_pipeline.pipeline_step_collection_factory.name_to_step_factory
    assert list(got) == list(ref)
    assert len(got) == 17 and all(n.startswith('text_detection.') for n in got)
    exported = {n for n in dir(jax_pipeline) if not n.startswith('_')}
    assert exported <= set(dir(torch_pipeline))


def test_step_configs_are_the_fixtures(pipeline_assets):
    ref = reference_configs(pipeline_assets)
    got = build_step_configs(pipeline_assets)
    assert [c['name'] for c in got] == [c['name'] for c in ref]
    for a, b in zip(ref, got):
        if b['name'] == 'text_detection.page_text_region_step':
            assert b['config'] == {'device': 'cuda'} and 'config' not in a
        else:
            assert a == b
    assert build_step_configs(pipeline_assets, side=2522)[0]['config'] == {
        'area': 2522 * 2522}


# ---------------------------------------------------------------------------
# The whole pipeline.
# ---------------------------------------------------------------------------


def test_pipeline_matches_the_reference_seed_2024(step_pair, kd_queries):
    differ = assert_pipeline_matches(step_pair, 2024)
    # The flattened page differs by 1 LSB at a handful of outline pixels.
    assert 0 < differ['PageTextRegionStep'] < 100
    # With cKDTree's answers step 16 would draw other regression labels.
    assert assert_kd_queries_are_sklearns(kd_queries) == (8104, 90, 45)


# ---------------------------------------------------------------------------
# Step 15's batched flatten alone.
# ---------------------------------------------------------------------------


def _rect(cy, cx, h, w, angle):
    rad = np.radians(angle)
    axis = np.array([np.cos(rad), np.sin(rad)])
    normal = np.array([-axis[1], axis[0]])
    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    return np.array([[cx, cy] + a * w / 2 * axis + b * h / 2 * normal
                     for a, b in corners])


def _flatten_inputs(seed):
    """A 256 x 320 page of noise, four text regions (rotated rects, each
    with a row of char quads along it) and one char-free region."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (256, 320, 3), dtype=np.uint8)
    regions, chars = [], []
    for cy, cx, h, w, angle, count in ((40, 80, 22, 110, 5, 5),
                                       (120, 200, 30, 160, -12, 6),
                                       (200, 90, 18, 60, 30, 3),
                                       (180, 250, 26, 70, 80, 2)):
        regions.append(_rect(cy, cx, h, w, angle))
        rad = np.radians(angle)
        step = w / count
        chars.append([
            _rect(cy + np.sin(rad) * (i + 0.5 - count / 2) * step,
                  cx + np.cos(rad) * (i + 0.5 - count / 2) * step,
                  h * 0.8, step * 0.8, angle)
            for i in range(count)
        ])
    regions.append(_rect(60, 250, 40, 50, 0))
    chars.append([])
    return image, regions, chars


@pytest.mark.parametrize('seed', [0, 1])
def test_flatten_text_regions_on_device_matches(seed):
    image, regions, chars = _flatten_inputs(seed)
    specs = [(0, 1.3, 0), (1, 0.7, 180), (2, 1.6, 90), (3, 1.1, 270),
             (4, 0.9, 0)]
    out = []
    for module, image_cls, polygon_cls, kwargs in (
            (JTR, JaxImage, JaxPolygon, {}),
            (TTR, Image, Polygon, {'device': 'cpu'})):
        flattener = module.TextRegionFlattener(
            typical_long_side_ratio_min=3.0,
            text_region_polygon_dilate_ratio=0.9,
            image=image_cls(mat=image),
            text_region_polygons=[polygon_cls.from_np_xy(r)
                                  for r in regions],
            grouped_char_polygons=[[polygon_cls.from_np_xy(c) for c in g]
                                   for g in chars],
            is_training=True,
            defer_flatten=True,
        )
        out.append(module.flatten_text_regions_on_device(
            image_cls(mat=image), flattener, specs, **kwargs))
    ref, got = out
    assert len(got) == len(specs)
    assert {ftr.post_rotate_angle for ftr in got} == {0, 90, 180, 270}
    assert assert_same_output(ref, got, 'flattened', flattened=True) \
        <= EDGE_SHARE * sum(f.flattened_image.mat.size for f in got)


def test_step_15_on_a_missing_card_raises(step_pair, monkeypatch):
    """``device='cuda'`` without a card raises the device layer's error;
    nothing falls back to the CPU or to the host flatten."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    image, regions, chars = _flatten_inputs(0)
    flattener = TTR.TextRegionFlattener(
        3.0, 0.9, Image(mat=image), [Polygon.from_np_xy(r) for r in regions],
        [[Polygon.from_np_xy(c) for c in g] for g in chars],
        is_training=True, defer_flatten=True,
    )
    with pytest.raises(convert.DeviceError, match='CUDA is not available'):
        TTR.flatten_text_regions_on_device(Image(mat=image), flattener,
                                           [(0, 1.0, 0)])
    assert TTR.PageTextRegionStepConfig().device == 'cuda'
    assert TTR.PageTextRegionStepConfig().enable_device_flatten
