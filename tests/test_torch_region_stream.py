"""The port's text-region stream and char gaussians as a whole
(vkit_tpu_torch/synth/region.py and the ``emit_char_gaussians`` /
``region_config`` branches of synth/device.py) against vkit_tpu's, each
package preparing its pages with its own planner from the same seed
(checked equal first) and synthesizing them with the same rng.  The
tolerances and their reasons are those of tests/test_torch_region.py.
"""
import copy

import numpy as np
import pytest
import torch

from tests.pipeline.fixtures import build_assets
from tests.test_torch_host import (
    assert_same_draws,
    assert_same_pages,
    planner_pair,
)
from tests.test_torch_region import EDGE_SHARE, assert_maps_close
from vkit_tpu.synth import RegionStreamConfig as JaxRegionStreamConfig
from vkit_tpu.synth import region as jax_region_mod
from vkit_tpu.synth import synthesize_page_batch as jax_synthesize
from vkit_tpu.synth import synthesize_stream as jax_synthesize_stream
from vkit_tpu_torch.mechanism.batched import RNG_CONSUMING
from vkit_tpu_torch.ops import region as region_ops
from vkit_tpu_torch.synth import (
    RegionStreamConfig,
    synthesize_page_batch,
    synthesize_stream,
)
from vkit_tpu_torch.synth import region as region_mod
from vkit_tpu_torch.synth.device import (
    SynthBatchResult,
    _char_gaussian_maps,
)

torch.set_num_threads(1)

STREAM_CONFIG = dict(page_size=320, target_char_height=24,
                     num_crops_per_page=1, crop_size=160)


@pytest.fixture(scope='module')
def planners(tmp_path_factory):
    assets = build_assets(tmp_path_factory.mktemp('torch_region_assets'))
    return planner_pair(assets, False)


def _prepare(planners, n, seed):
    jax_planner, planner = planners
    ref = jax_planner.prepare_batch(n, np.random.default_rng(seed))
    got = planner.prepare_batch(n, np.random.default_rng(seed))
    assert_same_pages(ref, got)
    return ref, got


def _boxes(boxes):
    return [(b.up, b.down, b.left, b.right) for b in boxes]


def _assert_images_close(ref, got):
    """uint8 images within 1 LSB outside the outline pixels."""
    diff = np.abs(ref.astype(int) - got.astype(int)).max(axis=-1)
    assert (diff > 1).sum() <= EDGE_SHARE * diff.size, (diff > 1).sum()


def assert_same_regions(ref, got, keep_on_device=False):
    """RegionBatchResults: host fields equal, rasters close."""
    assert (ref is None) == (got is None)
    if ref is None:
        return
    assert ref.num_pages == got.num_pages >= 1
    assert ref.num_crops == got.num_crops
    m = ref.num_pages
    assert [_boxes(b) for b in ref.region_boxes] == [
        _boxes(b) for b in got.region_boxes]
    for ref_page, got_page in zip(ref.char_polygons, got.char_polygons):
        assert len(ref_page) == len(got_page)
        for a, b in zip(ref_page, got_page):
            np.testing.assert_array_equal(a.to_np_array(), b.to_np_array())
    assert len(ref.regression) == len(got.regression) == m
    for a, b in zip(ref.regression, got.regression):
        for field in a._fields:
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
    images, active, maps = got.images, got.active_masks, got.gaussian_maps
    if keep_on_device:
        # The reference's padded page count; blank canvases beyond m.
        assert isinstance(images, torch.Tensor)
        assert images.shape[0] == np.asarray(ref.images).shape[0] >= m
        assert int(active[m:].sum()) == 0 and float(maps[m:].sum()) == 0.0
        images, active, maps = (t.numpy()[:m] for t in (images, active,
                                                        maps))
    ref_images, ref_active, ref_maps = (
        np.asarray(a)[:m] for a in (ref.images, ref.active_masks,
                                    ref.gaussian_maps))
    assert images.shape == ref_images.shape and images.dtype == np.uint8
    _assert_images_close(ref_images, images)
    assert (ref_active != active).sum() <= EDGE_SHARE * active.size
    assert active.sum() > 0
    assert_maps_close(ref_maps, maps)
    assert maps.max() > 0.3
    if ref.num_crops:
        k = ref.num_crops
        np.testing.assert_array_equal(ref.crop_page_ids, got.crop_page_ids)
        crops = [got.crop_images, got.crop_gaussians, got.crop_active]
        if keep_on_device:
            crops = [t.numpy() for t in crops]
        assert crops[0].shape[0] == k
        _assert_images_close(np.asarray(ref.crop_images)[:k], crops[0])
        assert_maps_close(np.asarray(ref.crop_gaussians)[:k], crops[1])
        assert (np.asarray(ref.crop_active)[:k] != crops[2]).sum() \
            <= EDGE_SHARE * crops[2].size


def test_char_gaussian_maps_match_reference(planners):
    """tests/synth/test_synth.py::test_char_gaussian_maps' shape: two
    320 x 320 pages, level 3."""
    ref_pages, pages = _prepare(planners, 2, 31)
    ref = jax_synthesize(ref_pages, 3, np.random.default_rng(32),
                         enable_photometric=False, emit_char_gaussians=True)
    got = synthesize_page_batch(pages, 3, np.random.default_rng(32),
                                enable_photometric=False,
                                emit_char_gaussians=True, device='cpu')
    assert isinstance(got.char_gaussian_maps, np.ndarray)
    assert got.char_gaussian_maps.shape == (2, 320, 320)
    assert got.char_gaussian_maps.dtype == np.float32
    assert got.char_gaussian_maps.max() > 0.5
    assert_maps_close(ref.char_gaussian_maps, got.char_gaussian_maps)
    kept = synthesize_page_batch(pages, 3, np.random.default_rng(32),
                                 enable_photometric=False,
                                 emit_char_gaussians=True,
                                 keep_on_device=True, device='cpu')
    assert isinstance(kept.char_gaussian_maps, torch.Tensor)
    np.testing.assert_array_equal(kept.char_gaussian_maps.numpy(),
                                  got.char_gaussian_maps)


def test_char_gaussian_maps_without_chars():
    out = _char_gaussian_maps([[], []], (16, 24), device='cpu')
    assert out.shape == (2, 16, 24) and float(out.abs().sum()) == 0.0


def test_collect_regions_equals_reference(planners):
    ref_pages, pages = _prepare(planners, 2, 33)
    ref = jax_synthesize(ref_pages, 3, np.random.default_rng(34),
                         enable_photometric=False)
    got = synthesize_page_batch(pages, 3, np.random.default_rng(34),
                                enable_photometric=False, device='cpu')
    ref_regions = jax_region_mod.collect_regions(
        ref, JaxRegionStreamConfig(**STREAM_CONFIG))
    got_regions = region_mod.collect_regions(
        got, RegionStreamConfig(**STREAM_CONFIG))
    assert len(ref_regions) == len(got_regions) > 4
    for a, b in zip(ref_regions, got_regions):
        assert a.page_id == b.page_id and a.char_idxs == b.char_idxs
        assert _boxes([a.window]) == _boxes([b.window])
        assert a.angle_deg == b.angle_deg and a.scale == b.scale
        np.testing.assert_array_equal(a.poly_xy, b.poly_xy)


@pytest.mark.parametrize('keep_on_device', [False, True])
def test_region_stream_matches_reference(planners, keep_on_device):
    """tests/synth/test_region_stream.py's stream: two batches of two
    320 x 320 pages, level 3, from one seed in both packages.  The
    photometric stage is on (the default), so a batch is compared only
    where none of its samples drew an rng-consuming op; the host fields
    do not depend on pixel values and are compared always."""
    jax_planner, planner = planners
    got = list(synthesize_stream(
        planner, 2, 3, np.random.default_rng(7), num_batches=2,
        region_config=RegionStreamConfig(**STREAM_CONFIG),
        keep_on_device=keep_on_device, device='cpu'))
    ref = list(jax_synthesize_stream(
        jax_planner, 2, 3, np.random.default_rng(7), num_batches=2,
        region_config=JaxRegionStreamConfig(**STREAM_CONFIG),
        keep_on_device=keep_on_device))
    assert len(got) == len(ref) == 2
    seed_rng = np.random.default_rng(7)
    compared = 0
    for a, b in zip(ref, got):
        batch_rng = np.random.default_rng(
            int(seed_rng.integers(0, 2**63 - 1)))
        planner.prepare_batch(2, batch_rng)
        draws = assert_same_draws(batch_rng, batch_rng, 2, (320, 320),
                                  level=3)
        names = {name for seq in draws for name, _ in seq}
        tr_ref, tr_got = a.text_regions, b.text_regions
        assert tr_ref is not None and tr_got is not None
        if names & RNG_CONSUMING:
            # Pixels differ by construction; the host half still matches.
            assert tr_ref.num_pages == tr_got.num_pages
            assert [_boxes(x) for x in tr_ref.region_boxes] == [
                _boxes(x) for x in tr_got.region_boxes]
            np.testing.assert_array_equal(tr_ref.crop_page_ids,
                                          tr_got.crop_page_ids)
            continue
        assert_same_regions(tr_ref, tr_got, keep_on_device)
        compared += 1
    assert compared >= 1


def test_region_pages_match_reference_without_distortion(planners):
    """tests/synth/test_region_stream.py::
    test_region_pages_carry_region_content's call: no photometric stage,
    no geometric plans, default crops off."""
    ref_pages, pages = _prepare(planners, 2, 11)
    config = dict(page_size=320, target_char_height=24)
    rng = np.random.default_rng(12)
    ref = jax_synthesize(ref_pages, 0, copy.deepcopy(rng),
                         enable_photometric=False, enable_geometric=False,
                         region_config=JaxRegionStreamConfig(**config))
    got = synthesize_page_batch(pages, 0, rng, enable_photometric=False,
                                enable_geometric=False,
                                region_config=RegionStreamConfig(**config),
                                device='cpu')
    assert got.text_regions.crop_images is None
    assert_same_regions(ref.text_regions, got.text_regions)


def test_chunked_flatten_matches_single_chunk(planners, monkeypatch):
    """Forcing the multi-chunk flatten (a tiny per-chunk budget) reproduces
    the single-chunk result exactly."""
    pages = planners[1].prepare_batch(2, np.random.default_rng(13))
    config = RegionStreamConfig(page_size=320, target_char_height=24)

    def run():
        return synthesize_page_batch(
            pages, 3, np.random.default_rng(5), region_config=config,
            device='cpu').text_regions

    base = run()
    assert base is not None and base.num_pages >= 1
    monkeypatch.setattr(region_mod, '_CHUNK_BUDGET_BYTES', 1)
    assert region_mod._chunk_rows(128) == 64
    assert sum(len(b) for b in base.region_boxes) > 64
    chunked = run()
    assert chunked.num_pages == base.num_pages
    np.testing.assert_array_equal(chunked.images, base.images)
    np.testing.assert_array_equal(chunked.active_masks, base.active_masks)
    np.testing.assert_array_equal(chunked.gaussian_maps, base.gaussian_maps)


def test_own_destination_tiles_match_one_tile_for_all(planners,
                                                      monkeypatch):
    """Each region flattened at its own destination tile composites the
    same pages as every region at the largest tile, chunk by chunk, with
    no chunk's rgba tiles past the budget unless it holds the least rows."""
    pages = planners[1].prepare_batch(2, np.random.default_rng(13))
    config = RegionStreamConfig(page_size=320, target_char_height=24)
    calls = []
    flatten = region_ops.batch_flatten_regions

    def recorded(patches, angles, scales, dst_tile, *args, **kwargs):
        calls.append((len(angles), dst_tile))
        return flatten(patches, angles, scales, dst_tile, *args, **kwargs)

    monkeypatch.setattr(region_ops, 'batch_flatten_regions', recorded)

    def run():
        calls.clear()
        return synthesize_page_batch(
            pages, 3, np.random.default_rng(5), region_config=config,
            device='cpu').text_regions

    monkeypatch.setattr(region_mod, '_CHUNK_BUDGET_BYTES', 64 << 20)
    own = run()
    own_calls = list(calls)
    assert len({dst for _, dst in own_calls}) >= 2
    for rows, dst in own_calls:
        assert rows * dst * dst * 16 <= 64 << 20 or rows <= 64
    monkeypatch.setattr(region_mod, '_dst_tile',
                        lambda need, config: config.dst_tile_max)
    one = run()
    assert {dst for _, dst in calls} == {config.dst_tile_max}
    assert one.num_pages == own.num_pages
    np.testing.assert_array_equal(own.images, one.images)
    np.testing.assert_array_equal(own.active_masks, one.active_masks)
    np.testing.assert_array_equal(own.gaussian_maps, one.gaussian_maps)
    assert [_boxes(b) for b in own.region_boxes] == [
        _boxes(b) for b in one.region_boxes]


@pytest.mark.parametrize('need, tile', [
    (1, 128), (128, 128), (129, 256), (256, 256), (300, 512), (512, 512),
    (700, 512)])
def test_a_region_takes_the_least_destination_tile_that_holds_it(need,
                                                                 tile):
    assert region_mod._dst_tile(need, RegionStreamConfig()) == tile


@pytest.mark.parametrize('tile, dst_tile, rows', [
    (64, 128, 1024), (64, 256, 1024), (64, 512, 256), (128, 512, 256),
    (512, 512, 128)])
def test_flatten_chunk_rows_fit_the_budget(tile, dst_tile, rows):
    assert region_mod._flatten_rows(tile, dst_tile) == rows


def test_no_text_returns_none():
    """A batch without a usable region stacks nothing."""
    blank = SynthBatchResult(
        images=np.zeros((1, 32, 32, 3), np.uint8),
        label_stack=np.zeros((1, 32, 32, 4), np.float32),
        active_masks=np.ones((1, 32, 32), np.uint8),
        content_boxes=[], word_polygons=[[]], char_polygons=[[]],
        char_quads=[np.zeros((0, 4, 2))],
    )
    assert region_mod.stack_text_regions(
        blank, RegionStreamConfig(page_size=32), np.random.default_rng(0),
        device='cpu') is None
