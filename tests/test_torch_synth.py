"""The port's page-synthesis slice (vkit_tpu_torch/synth/device.py) against
vkit_tpu's synthesize_page_batch, with the photometric stage off and on
(the default of both).  Each package prepares its pages with its own
planner from the same seed (checked equal first), and synthesizes them
with the same rng, so the same photometric draws, plans and crop windows,
draw for draw."""
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
from vkit_tpu.synth import CropConfig as JaxCropConfig
from vkit_tpu.synth import synthesize_page_batch as jax_synthesize
from vkit_tpu_torch.mechanism.batched import RNG_CONSUMING
from vkit_tpu_torch.synth import (
    CropConfig,
    synthesize_page_batch,
    synthesize_stream,
)

torch.set_num_threads(1)

OUT = (256, 256)
CROP = CropConfig(core_size=192, num_per_page=2)
JAX_CROP = JaxCropConfig(core_size=192, num_per_page=2)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp('torch_synth_assets'))


@pytest.fixture(scope='module')
def planners(assets):
    """{content: (vkit_tpu's planner, the port's)}: the 320 x 320 planner
    of tests/synth/test_synth.py, text only or full content."""
    return {'text': planner_pair(assets, False),
            'full': planner_pair(assets, True)}


def prepare_pair(planners, content, n, seed):
    """(vkit_tpu's pages, the port's) from the same seed, checked equal."""
    jax_planner, torch_planner = planners[content]
    ref = jax_planner.prepare_batch(n, np.random.default_rng(seed))
    got = torch_planner.prepare_batch(n, np.random.default_rng(seed))
    assert_same_pages(ref, got)
    return ref, got


def _boxes(boxes):
    return [(b.up, b.down, b.left, b.right) for b in boxes]


# Ops that round an HSV / HSL intermediate to uint8: a pixel on a rounding
# boundary may land up to 8 LSB apart (tests/test_torch_photometric.py),
# and later ops of the draw (posterization, equalization) can widen that
# step.  Such samples are held to a mean < 0.5 LSB with under 0.1% of
# pixels more than 1 LSB apart.
HSV_ROUNDING = frozenset({'color_shift', 'brightness_shift'})


def photometric_draws(rng, n, shape, level=5):
    """Each sample's photometric draws, replayed by both packages on copies
    of ``rng`` and checked equal."""
    return assert_same_draws(rng, rng, n, shape, level)


def assert_same_result(ref, got, draws=None):
    """Same analytic results; images within 1 LSB inside the active masks.
    With photometric ``draws``, images are compared per sample where the
    sample drew no rng-consuming op (at the HSV rounding bound above where
    it drew color_shift / brightness_shift)."""
    assert np.array_equal(ref.active_masks, got.active_masks)
    assert _boxes(ref.content_boxes) == _boxes(got.content_boxes)
    for ref_pages, got_pages in ((ref.word_polygons, got.word_polygons),
                                 (ref.char_polygons, got.char_polygons)):
        for a_page, b_page in zip(ref_pages, got_pages):
            assert len(a_page) == len(b_page)
            for a, b in zip(a_page, b_page):
                assert np.array_equal(a.to_np_array(), b.to_np_array())
    active = ref.active_masks > 0
    assert active.any()
    lab = np.abs(ref.label_stack - got.label_stack)
    assert lab[active].max() <= 1e-2
    img = np.abs(ref.images.astype(int) - got.images.astype(int))
    if draws is None:
        draws = [[] for _ in range(len(img))]
    compared = 0
    for sample, seq in enumerate(draws):
        names = {name for name, _ in seq}
        if names & RNG_CONSUMING:
            continue
        diff = img[sample][active[sample]]
        if names & HSV_ROUNDING:
            assert diff.mean() < 0.5 and (diff > 1).mean() < 1e-3
        else:
            assert diff.max() <= 1, (sample, names, diff.max())
        compared += 1
    assert compared > 0
    assert ref.num_crops == got.num_crops
    if ref.num_crops:
        count = ref.num_crops
        assert np.array_equal(ref.crop_windows, got.crop_windows)
        assert np.array_equal(ref.crop_page_ids, got.crop_page_ids)
        assert got.crop_images.shape[0] == count
        assert np.array_equal(ref.crop_active[:count], got.crop_active)
        for k, sample in enumerate(ref.crop_page_ids):
            names = {name for name, _ in draws[sample]}
            if not names & (RNG_CONSUMING | HSV_ROUNDING):
                crop = np.abs(ref.crop_images[k].astype(int)
                              - got.crop_images[k].astype(int))
                assert crop.max() <= 1


@pytest.mark.parametrize('content,seed', [('text', 5), ('full', 6)])
def test_page_batch_matches_jax(planners, content, seed):
    ref_pages, pages = prepare_pair(planners, content, 2, seed)
    if content == 'full':
        assert any(p.overlay_entries for p in pages)
    ref = jax_synthesize(ref_pages, 5, np.random.default_rng(seed + 100),
                         out_shape=OUT, enable_photometric=False,
                         crop_config=JAX_CROP)
    got = synthesize_page_batch(pages, 5, np.random.default_rng(seed + 100),
                                out_shape=OUT, enable_photometric=False,
                                crop_config=CROP, device='cpu')
    assert isinstance(got.images, np.ndarray)
    assert got.images.shape == (2,) + OUT + (3,)
    assert_same_result(ref, got)


def test_no_geometric_matches_jax(planners):
    """Nop plans: the affine route and the constant-stretch finish."""
    ref_pages, pages = prepare_pair(planners, 'text', 2, 8)
    ref = jax_synthesize(ref_pages, 5, np.random.default_rng(1),
                         enable_photometric=False, enable_geometric=False)
    got = synthesize_page_batch(pages, 5, np.random.default_rng(1),
                                enable_photometric=False,
                                enable_geometric=False, device='cpu')
    assert_same_result(ref, got)


@pytest.mark.parametrize('seed', [12, 13])
def test_photometric_page_batch_matches_jax(planners, seed):
    """The reference's default: the photometric stage on."""
    ref_pages, pages = prepare_pair(planners, 'full', 4, seed)
    rng = np.random.default_rng(seed + 100)
    draws = photometric_draws(rng, 4, pages[0].background.shape[:2])
    assert any(draws)
    ref = jax_synthesize(ref_pages, 5, copy.deepcopy(rng), out_shape=OUT,
                         crop_config=JAX_CROP)
    got = synthesize_page_batch(pages, 5, rng, out_shape=OUT,
                                crop_config=CROP, device='cpu')
    assert_same_result(ref, got, draws)


def test_stream_matches_jax(planners):
    """The stream's per-batch child rngs drive prep and synthesis (the
    photometric stage on, as in the reference's stream); the reference run
    replays them through vkit_tpu batch by batch."""
    jax_planner, planner = planners['text']
    got = list(synthesize_stream(planner, 2, 5, np.random.default_rng(9),
                                 num_batches=2, out_shape=OUT,
                                 crop_config=CROP, device='cpu'))
    rng = np.random.default_rng(9)
    seeds = [int(rng.integers(0, 2**63 - 1)) for _ in range(2)]
    assert len(got) == 2
    for seed, result in zip(seeds, got):
        batch_rng = np.random.default_rng(seed)
        ref_pages = jax_planner.prepare_batch(2, batch_rng)
        assert_same_pages(ref_pages, planner.prepare_batch(
            2, np.random.default_rng(seed)))
        draws = photometric_draws(batch_rng, 2,
                                  ref_pages[0].background.shape[:2])
        ref = jax_synthesize(ref_pages, 5, batch_rng, out_shape=OUT,
                             crop_config=JAX_CROP)
        assert_same_result(ref, result, draws)


def test_keep_on_device_returns_tensors(planners):
    pages = planners['text'][1].prepare_batch(1, np.random.default_rng(4))
    out = synthesize_page_batch(pages, 5, np.random.default_rng(4),
                                out_shape=OUT, crop_config=CROP,
                                keep_on_device=True, device='cpu')
    assert isinstance(out.images, torch.Tensor)
    assert out.images.dtype == torch.uint8
    assert out.label_stack.dtype == torch.float32
    assert out.active_masks.dtype == torch.uint8
    assert torch.isfinite(out.label_stack).all()
    if out.num_crops:
        assert isinstance(out.crop_images, torch.Tensor)
        assert out.crop_images.shape[0] == out.num_crops


def test_stage_timer_spans_leave_result_unchanged(planners):
    """A timer records one span per stage and changes nothing."""
    from vkit_tpu_torch.utility.profiling import StepTimer

    pages = planners['full'][1].prepare_batch(2, np.random.default_rng(14))
    plain = synthesize_page_batch(pages, 5, np.random.default_rng(15),
                                  out_shape=OUT, crop_config=CROP,
                                  device='cpu')
    timer = StepTimer()
    timed = synthesize_page_batch(pages, 5, np.random.default_rng(15),
                                  out_shape=OUT, crop_config=CROP,
                                  device='cpu', timer=timer)
    assert set(timer.counts) == {
        'assemble', 'photometric', 'plan-host', 'warp', 'active-host',
        'finish', 'polygons-host', 'crops', 'fetch',
    }
    assert all(count == 1 for count in timer.counts.values())
    np.testing.assert_array_equal(timed.images, plain.images)
    np.testing.assert_array_equal(timed.label_stack, plain.label_stack)
    np.testing.assert_array_equal(timed.crop_windows, plain.crop_windows)


@pytest.mark.parametrize('option', ['gaussians', 'region'])
def test_unported_options_raise(planners, option):
    pages = planners['text'][1].prepare_batch(1, np.random.default_rng(0))
    kwargs = {
        'gaussians': {'emit_char_gaussians': True},
        'region': {'region_config': object()},
    }[option]
    with pytest.raises(NotImplementedError):
        synthesize_page_batch(pages, 5, np.random.default_rng(0),
                              device='cpu', **kwargs)
