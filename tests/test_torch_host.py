"""The port's own host layers (vkit_tpu_torch's copies of vkit_tpu's numpy /
C++ code) against vkit_tpu's: the port imports neither jax nor vkit_tpu,
and from the same seed both packages draw the same pages, plans, routes
and photometric draws.  The helpers here (``assert_same_pages``,
``assert_same_plans``, ``assert_same_draws``) also serve the other
``tests/test_torch_*.py`` files, which check that both sides drew the
same before comparing outputs."""
import ast
import copy
import dataclasses
import enum
import json
import os
import subprocess
import sys
from pathlib import Path

import attr
import numpy as np
import pytest
import torch

from tests.pipeline.fixtures import build_assets
from vkit_tpu.geometry import _native as jax_native
from vkit_tpu.mechanism import batched as JB
from vkit_tpu.mechanism.batched_random import (
    sample_geometric_plans as jax_sample_geometric_plans,
)
from vkit_tpu.mechanism.distortion_policy.random_distortion import (
    RandomDistortionStage as JaxStage,
)
from vkit_tpu.mechanism.distortion_policy.random_distortion import (
    random_distortion_factory as jax_factory,
)
from vkit_tpu.ops import warp_banded as JWB
from vkit_tpu.ops import warp_mxu as JWM
from vkit_tpu.synth import SynthPlanner as JaxPlanner
from vkit_tpu.synth import SynthPlannerConfig as JaxPlannerConfig
from vkit_tpu_torch.geometry import _native as torch_native
from vkit_tpu_torch.mechanism import batched as TB
from vkit_tpu_torch.mechanism.batched_random import (
    sample_geometric_plans,
    sample_photometric_sequences,
)
from vkit_tpu_torch.ops import warp_banded as TWB
from vkit_tpu_torch.ops import warp_mxu as TWM
from vkit_tpu_torch.synth import SynthPlanner, SynthPlannerConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'vkit_tpu_torch'
FORBIDDEN = ('vkit_tpu', 'jax', 'flax', 'optax')


# ---------------------------------------------------------------------------
# Helpers shared with the other port tests.
# ---------------------------------------------------------------------------


def assert_same_value(a, b, where='value'):
    """Equal nested values: numpy arrays exactly, attrs instances field by
    field (class names equal, as the two packages' classes differ)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    elif attr.has(type(a)):
        assert type(a).__name__ == type(b).__name__, where
        for field in attr.fields(type(a)):
            assert_same_value(getattr(a, field.name), getattr(b, field.name),
                              f'{where}.{field.name}')
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_value(x, y, f'{where}[{i}]')
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for key in a:
            assert_same_value(a[key], b[key], f'{where}[{key!r}]')
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__, where
        assert (a.name, a.value) == (b.name, b.value), where
    elif type(a).__module__.startswith(('vkit_tpu.', 'vkit_tpu_torch.')):
        # Plain classes of either package.
        assert type(a).__name__ == type(b).__name__, where
        assert_same_value(vars(a), vars(b), where)
    else:
        assert a == b, (where, a, b)


def assert_same_plans(ref_plans, got_plans):
    """Equal WarpPlans, every field but the cache."""
    assert len(ref_plans) == len(got_plans)
    for i, (a, b) in enumerate(zip(ref_plans, got_plans)):
        for field in dataclasses.fields(a):
            if field.name == '_cache':
                continue
            assert_same_value(getattr(a, field.name), getattr(b, field.name),
                              f'plan {i}.{field.name}')


def _polygons(polygons):
    return [p.to_np_array() for p in polygons]


def assert_same_pages(ref_pages, got_pages):
    """Equal HostPages: rasters, glyph placements (layouts, anchors,
    colors and each atlas's glyph ids and tiles), text-line boxes,
    polygons and overlay patches."""
    assert len(ref_pages) == len(got_pages)
    for a, b in zip(ref_pages, got_pages):
        np.testing.assert_array_equal(a.background, b.background)
        np.testing.assert_array_equal(a.label_stack, b.label_stack)
        assert len(a.line_entries) == len(b.line_entries)
        for (la, anchor_a, color_a, atlas_a), (lb, anchor_b, color_b,
                                               atlas_b) in zip(
                a.line_entries, b.line_entries):
            assert anchor_a == anchor_b and tuple(color_a) == tuple(color_b)
            assert_same_value(la.char_boxes, lb.char_boxes, 'char_boxes')
            assert list(la.glyph_ids) == list(lb.glyph_ids)
            assert list(la.src_hs) == list(lb.src_hs)
            assert list(la.src_ws) == list(lb.src_ws)
            assert atlas_a._char_to_id == atlas_b._char_to_id
            np.testing.assert_array_equal(atlas_a.tiles, atlas_b.tiles)
        assert [(t.box.up, t.box.down, t.box.left, t.box.right)
                for t in a.text_lines] == [
            (t.box.up, t.box.down, t.box.left, t.box.right)
            for t in b.text_lines]
        for pa, pb in ((a.word_polygons, b.word_polygons),
                       (a.char_polygons, b.char_polygons)):
            assert len(pa) == len(pb)
            for x, y in zip(_polygons(pa), _polygons(pb)):
                np.testing.assert_array_equal(x, y)
        assert len(a.overlay_entries) == len(b.overlay_entries)
        for ea, eb in zip(a.overlay_entries, b.overlay_entries):
            assert_same_value(ea, eb, 'overlay')


def reference_photometric_draws(n, shape, level, rng, stage_config=None):
    """vkit_tpu's batch_random_photometric_distort host draws, replayed:
    the base seed, then per sample rng.random(), the policies and their
    configs (vkit_tpu/mechanism/batched_random.py)."""
    if stage_config is None:
        stage_config = jax_factory.create_photometric_stage_config()
    stage = JaxStage(stage_config)
    base_seed = int(rng.integers(0, 2**31 - 1))
    sequences = []
    for _ in range(n):
        policies = ()
        if rng.random() <= stage_config.prob_enable:
            policies = stage.sample_distortion_policies(rng)
        sequences.append([(p.name, p.sample_config(level, shape, rng))
                          for p in policies])
    return base_seed, sequences


def assert_same_draws(ref_rng, got_rng, n, shape, level=5, ref_stage=None,
                      stage=None):
    """Both packages' photometric draws (from their stage configs, the
    default ones unless given) from copies of two rngs in the same state:
    equal seeds, names and configs, and the rngs left in the same state.
    Returns the draws."""
    ref_rng, got_rng = copy.deepcopy(ref_rng), copy.deepcopy(got_rng)
    ref = reference_photometric_draws(n, shape, level, ref_rng, ref_stage)
    got = sample_photometric_sequences(n, shape, level, got_rng, stage)
    assert ref[0] == got[0]
    assert_same_value(ref[1], got[1], 'draws')
    assert ref_rng.bit_generator.state == got_rng.bit_generator.state
    return got[1]


def planner_config(assets, full_content: bool, side: int = 320):
    """The 320 x 320 planner of tests/synth/test_synth.py, text only or
    with every page_assembler layer; a dict of SynthPlannerConfig
    fields."""
    extra = {}
    if full_content:
        selector = [{'type': 'selector', 'weight': 1,
                     'config': {'image_folders': [assets['bg_image_folder']]}}]
        extra = dict(
            background_image_configs=selector,
            image_configs=selector,
            symbol_image_folders=[assets['symbol_image_folder']],
            enable_barcodes=True,
            enable_seal_impressions=True,
            enable_text_line_bounding_boxes=True,
        )
    return dict(
        lexicon_collection_json=assets['lexicon_json'],
        font_collection_folder=assets['font_collection_folder'],
        char_sampler_configs=[{
            'type': 'corpus', 'weight': 1,
            'config': {'txt_files': [assets['corpus_txt']]},
        }],
        page_height=side, page_width=side, **extra,
    )


def planner_pair(assets, full_content: bool, side: int = 320):
    """(vkit_tpu's SynthPlanner, the port's) from one config."""
    config = planner_config(assets, full_content, side)
    return (JaxPlanner(JaxPlannerConfig(**config)),
            SynthPlanner(SynthPlannerConfig(**config)))


# ---------------------------------------------------------------------------
# (a), (b): no jax, no vkit_tpu.
# ---------------------------------------------------------------------------


_IMPORT_ALL = '''
import importlib, json, os, pkgutil, sys
import vkit_tpu_torch
for info in pkgutil.walk_packages(vkit_tpu_torch.__path__, 'vkit_tpu_torch.'):
    importlib.import_module(info.name)
loaded = sorted(
    name for name in sys.modules
    if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'vkit_tpu')
)
print(json.dumps({'loaded': loaded,
                  'jax_platforms': os.environ.get('JAX_PLATFORMS'),
                  'modules': sum(n.startswith('vkit_tpu_torch')
                                 for n in sys.modules)}))
'''


def test_importing_the_port_loads_no_jax_and_no_vkit_tpu():
    env = {k: v for k, v in os.environ.items() if k != 'JAX_PLATFORMS'}
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report['loaded'] == []
    assert report['jax_platforms'] is None
    assert report['modules'] > 80


def _forbidden_imports(path: Path):
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        found += [f'{path.name}:{node.lineno} {name}' for name in names
                  if name.split('.')[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize('scope', ['package', 'chip_smoke'])
def test_no_forbidden_imports_in_sources(scope):
    paths = (sorted(PORT.rglob('*.py')) if scope == 'package'
             else [REPO / 'chip_smoke.py'])
    assert paths
    assert [hit for path in paths for hit in _forbidden_imports(path)] == []


def test_stand_in_modules_are_gone():
    assert not (PORT / '_host_deps.py').exists()
    assert 'JAX_PLATFORMS' not in (PORT / '__init__.py').read_text()


# ---------------------------------------------------------------------------
# (c): the page planners.
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp('torch_host_assets'))


@pytest.fixture(scope='module')
def planners(assets):
    # full640: the planner chip_smoke.py drives (its make_planner).
    return {'text': planner_pair(assets, False),
            'full': planner_pair(assets, True),
            'full640': planner_pair(assets, True, 640)}


@pytest.mark.parametrize('content,seed', [('text', 0), ('text', 1),
                                          ('full', 2), ('full', 3),
                                          ('full640', 4), ('full640', 5)])
def test_planners_draw_the_same_pages(planners, content, seed):
    jax_planner, torch_planner = planners[content]
    ref_rng = np.random.default_rng(seed)
    got_rng = np.random.default_rng(seed)
    ref = jax_planner.prepare_batch(2, ref_rng)
    got = torch_planner.prepare_batch(2, got_rng)
    if content != 'text':
        assert any(p.overlay_entries for p in got)
    assert sum(len(p.line_entries) for p in got) > 0
    assert_same_pages(ref, got)
    assert ref_rng.bit_generator.state == got_rng.bit_generator.state


# ---------------------------------------------------------------------------
# (d): geometric plans, photometric draws, warp plans.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('level', [1, 5, 10])
def test_geometric_plans_match(level):
    ref_rng, got_rng = (np.random.default_rng(40 + level) for _ in range(2))
    ref = jax_sample_geometric_plans(16, (96, 128), level, ref_rng)
    got = sample_geometric_plans(16, (96, 128), level, got_rng)
    assert_same_plans(ref, got)
    assert ref_rng.bit_generator.state == got_rng.bit_generator.state


@pytest.mark.parametrize('level', [1, 5, 10])
def test_photometric_draws_match(level):
    rng = np.random.default_rng(60 + level)
    draws = assert_same_draws(rng, rng, 24, (96, 128), level)
    assert any(draws)


def _is_affine(plan):
    if plan.matrix is None:
        return False
    mat = np.asarray(plan.matrix, np.float64)
    return mat.shape == (2, 3) or np.abs(mat[2, :2]).max() < 1e-9


def _affine_and_field(plans):
    """The affine plans (the two-shear route) and the rest that warp."""
    return ([p for p in plans if _is_affine(p)],
            [p for p in plans if not _is_affine(p) and not p.nop])


@pytest.mark.parametrize('level', [1, 5, 10])
def test_warp_plans_match(level):
    shape, canvas = (160, 160), (176, 176)
    ref_plans = jax_sample_geometric_plans(
        16, shape, level, np.random.default_rng(80 + level))
    got_plans = sample_geometric_plans(
        16, shape, level, np.random.default_rng(80 + level))
    from vkit_tpu.mechanism.distortion.warp_plan import (
        rescale_plan_to as jax_rescale,
    )
    from vkit_tpu_torch.mechanism.distortion.warp_plan import rescale_plan_to

    ref_plans = [jax_rescale(p, canvas) for p in ref_plans]
    got_plans = [rescale_plan_to(p, canvas) for p in got_plans]
    assert_same_plans(ref_plans, got_plans)
    ref_aff, ref_lat = _affine_and_field(ref_plans)
    got_aff, got_lat = _affine_and_field(got_plans)
    checked = 0
    if ref_aff:
        mats = np.stack([np.asarray(p.matrix, np.float64) for p in ref_aff])
        ref_q = JWM.quadrant_reduce_mats(mats, shape)
        got_q = TWM.quadrant_reduce_mats(
            np.stack([np.asarray(p.matrix, np.float64) for p in got_aff]),
            shape)
        assert_same_value(ref_q, got_q, 'quadrants')
        ref_plan = JWM.plan_affine_warp(ref_q[1], shape, canvas,
                                        canonical=True)
        got_plan = TWM.plan_affine_warp(got_q[1], shape, canvas,
                                        canonical=True)
        assert_same_value(tuple(ref_plan[1]), tuple(got_plan[1]), 'statics')
        for pass_name in ('pass_v', 'pass_h'):
            assert_same_value(tuple(getattr(ref_plan[0], pass_name)),
                              tuple(getattr(got_plan[0], pass_name)),
                              pass_name)
        checked += 1
    if ref_lat:
        shapes = [p.dst_shape for p in ref_lat]
        ref_nodes = JB._build_coarse_nodes(ref_lat, shapes, canvas)
        got_nodes = TB._build_coarse_nodes(got_lat, shapes, canvas)
        assert_same_value(ref_nodes, got_nodes, 'nodes')
        ref_b = JWB.plan_banded_warp(*ref_nodes, shape, canvas)
        got_b = TWB.plan_banded_warp(*got_nodes, shape, canvas)
        assert (ref_b is None) == (got_b is None)
        if ref_b is not None:
            for pass_name in ('pass_v', 'pass_h'):
                assert_same_value(
                    [np.asarray(v) for v in getattr(ref_b[0], pass_name)],
                    [np.asarray(v) for v in getattr(got_b[0], pass_name)],
                    pass_name)
            assert_same_value(list(ref_b[1:]), list(got_b[1:]), 'routes')
        checked += 1
    assert checked


# ---------------------------------------------------------------------------
# The copies themselves: every definition the port shares with vkit_tpu.
# ---------------------------------------------------------------------------

# Names whose use marks a reference definition as device code, which the
# port rewrites in PyTorch (or, for a cache of jax arrays, in numpy).
JAX_NAMES = frozenset({'jax', 'jnp', 'lax', 'pl', 'pltpu'})

# Shared definitions that use no jax name themselves yet differ on purpose,
# by module: device code that calls the port's PyTorch ops or takes a
# ``device``, the port's own native loader, and trimmed package exports.
PORTED = {
    'engine/font/atlas.py': {'pack_placements'},
    'mechanism/batched.py': {
        '=_INTERP_W_CACHE', '_apply_complement', '_apply_filter2d',
        '_apply_fog', '_apply_mean_shift', 'batch_distort_members',
        'batched_defocus_blur', 'batched_ellipse_streak',
        'batched_gaussian_blur', 'batched_histogram_equalization',
        'batched_line_streak', 'batched_motion_blur',
        'batched_rectangle_streak',
    },
    'mechanism/batched_random.py': {'batch_random_distort',
                                    'batch_random_geometric_distort'},
    'native/__init__.py': {'_build', 'load_library'},
    'ops/common.py': {'expand_chw'},
    'synth/__init__.py': {'=__all__'},
    'synth/device.py': {'_composite_overlays', 'synthesize_stream'},
}


def _definitions(path: Path):
    """Qualified name -> AST node: module-level functions and named
    assignments, and for each class (nested ones too) its methods, its
    bases and decorators, and its other statements (its fields)."""
    found = {}

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found[prefix + node.name] = node
            elif isinstance(node, ast.ClassDef):
                name = prefix + node.name
                walk(node.body, name + '.')
                found[name + ':head'] = ast.Tuple(
                    [*node.bases, *node.decorator_list,
                     *(k.value for k in node.keywords)], ast.Load())
                found[name + ':fields'] = ast.Module(
                    [s for s in node.body if not isinstance(
                        s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef))], [])
            elif not prefix and isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = [t.id for t in targets if isinstance(t, ast.Name)]
                if names:
                    found['=' + ','.join(names)] = node

    walk(ast.parse(path.read_text(), str(path)).body, '')
    return found


def _uses_jax(node):
    return any(isinstance(n, ast.Name) and n.id in JAX_NAMES
               for n in ast.walk(node))


COUNTERPARTS = sorted(
    str(path.relative_to(PORT)) for path in PORT.rglob('*.py')
    if (REPO / 'vkit_tpu' / path.relative_to(PORT)).exists())


def test_counterparts_cover_the_copied_packages():
    copied = ('element/', 'engine/', 'geometry/', 'mechanism/distortion/',
              'mechanism/distortion_policy/', 'pipeline/', 'utility/')
    assert len(COUNTERPARTS) > 90
    for prefix in copied:
        assert any(m.startswith(prefix) for m in COUNTERPARTS), prefix
    assert set(PORTED) <= set(COUNTERPARTS)


@pytest.mark.parametrize('module', COUNTERPARTS)
def test_copied_definitions_equal_the_reference(module):
    """Each definition the port shares with vkit_tpu (same module path,
    same qualified name) has the reference's AST, docstring included:
    only imports, device code and the listed definitions differ."""
    ref = _definitions(REPO / 'vkit_tpu' / module)
    got = _definitions(PORT / module)
    differ = {name for name in ref.keys() & got.keys()
              if ast.dump(ref[name]) != ast.dump(got[name])
              and not _uses_jax(ref[name])}
    assert differ == PORTED.get(module, set())


# ---------------------------------------------------------------------------
# (e): the native geometry library.
# ---------------------------------------------------------------------------


def test_native_sources_are_the_same():
    assert (PORT / 'native' / 'geometry.cpp').read_bytes() == (
        REPO / 'vkit_tpu' / 'native' / 'geometry.cpp').read_bytes()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_native_fill_poly_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        count = int(rng.integers(3, 9))
        points = rng.uniform(-10, 70, (count, 2))
        np.testing.assert_array_equal(
            jax_native.fill_poly(points, (64, 60)),
            torch_native.fill_poly(points, (64, 60)),
        )


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_native_label8_matches(seed):
    mask = np.random.default_rng(seed).random((48, 56)) > 0.6
    ref = jax_native.disconnected_components(mask)
    got = torch_native.disconnected_components(mask)
    assert len(ref) == len(got) > 1
    for a, b in zip(ref, got):
        assert_same_value(a, b, 'component')
