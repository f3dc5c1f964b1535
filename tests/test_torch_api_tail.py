"""The rest of vkit_tpu's public API in the port, against vkit_tpu on the
same seeded inputs: the single-image warps (``remap``, ``remap_batch``,
``affine_maps``, ``warp_affine``, ``warp_perspective``), the single-image
photometric ops (``equalize_hist``, ``gaussian_blur``, ``box_blur``,
``jpeg_quality``, ``pixelation``) and their host twins, the batched
bit-exact JPEG roundtrip against the reference's single-image form under
``jax.vmap``, ``batch_distort_images_compiled``, the glyph placement table
of ``placements_for_text_lines``, ``AtlasPack.device_tiles_and_resolver``
and ``device_trace``.  vkit_tpu runs on the CPU; so does the port.

Tolerances, measured with both packages on the CPU:
- remap with the same maps: nearest exact, bilinear within 1 LSB (a uint8
  result rounds a float32 sum) and 1e-4 in float32;
- affine_maps: both invert the matrix in float32, by different LAPACK
  calls; the maps agree within 1e-4 px at these sizes (measured 1.5e-5 on
  a 100 x 120 canvas), so warp_affine / warp_perspective agree within 1
  LSB (bilinear) and on all but 0.1% of the pixels (nearest, where a map
  sits at a half pixel);
- equalize_hist, box_blur, pixelation and jpeg_quality_np exact;
  gaussian_blur within 1 LSB;
- jpeg_quality: the DCT is float32 sums in another order, so a
  coefficient whose ``coeff / q`` lies at a rounding boundary can round
  the other way and move its block by up to q / 4 (measured: up to 20 LSB
  at quality 5, up to 3.2% of the pixels 1-2 LSB apart at quality 90, most
  cases exact); held to at most 4% of the pixels apart, a mean of 0.15 LSB
  and a max of 32 LSB."""
import glob
import json

import attr
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tests.engine.fixtures import build_font_collection
from tests.test_torch_glyph import _line_entries, _port_font_meta
from vkit_tpu.engine.font import FontEngineRunConfig as JaxRunConfig
from vkit_tpu.engine.font.atlas import AtlasPack as JaxAtlasPack
from vkit_tpu.engine.font.atlas import get_glyph_atlas as jax_get_glyph_atlas
from vkit_tpu.engine.font.atlas import (
    placements_for_text_lines as jax_placements_for_text_lines,
)
from vkit_tpu.engine.font.atlas import (
    plan_text_line_layout as jax_plan_text_line_layout,
)
from vkit_tpu.ops import blur as JBlur
from vkit_tpu.ops import color as JC
from vkit_tpu.ops import effect as JE
from vkit_tpu.ops import glyph as JG
from vkit_tpu.ops import jpeg_exact as JJ
from vkit_tpu.ops import warp as JW
from vkit_tpu_torch import convert
from vkit_tpu_torch.engine import font as TF
from vkit_tpu_torch.engine.font.atlas import (
    AtlasPack,
    get_glyph_atlas,
    placements_for_text_lines,
    plan_text_line_layout,
)
from vkit_tpu_torch.mechanism.batched import (
    RNG_CONSUMING,
    _CATALOG,
    batch_distort_images,
    batch_distort_images_compiled,
)
from vkit_tpu_torch.mechanism.batched_random import _static_signature
from vkit_tpu_torch.mechanism.distortion_policy.random_distortion import (
    random_distortion_factory,
)
from vkit_tpu_torch.ops import blur as TBlur
from vkit_tpu_torch.ops import color as TC
from vkit_tpu_torch.ops import effect as TE
from vkit_tpu_torch.ops import glyph as TG
from vkit_tpu_torch.ops import jpeg_exact as TJ
from vkit_tpu_torch.ops import warp as TW
from vkit_tpu_torch.utility import device_trace

torch.set_num_threads(1)

AFFINE_MAP_TOL = 1e-4
NEAREST_FLIP_SHARE = 1e-3
JPEG_QUALITY_SHARE = 0.04
JPEG_QUALITY_MEAN = 0.15
JPEG_QUALITY_MAX = 32


def _smooth(shape, seed=0):
    rng = np.random.default_rng(seed)
    sigma = (2, 2, 0)[:len(shape)]
    return gaussian_filter(rng.random(shape) * 255, sigma=sigma).astype(
        np.uint8)


def _noisy(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _lsb(ref, got):
    return np.abs(np.asarray(ref).astype(np.float64)
                  - np.asarray(got).astype(np.float64))


# ---------------------------------------------------------------------------
# ops/warp.py
# ---------------------------------------------------------------------------


def _maps(shape, src_shape, seed=2):
    """Smooth backward maps that leave the source here and there."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    map_y = (ys * src_shape[0] / h + 6 * np.sin(xs / 9 + rng.random())
             - 3).astype(np.float32)
    map_x = (xs * src_shape[1] / w + 5 * np.cos(ys / 7 + rng.random())
             - 2).astype(np.float32)
    return map_y, map_x


@pytest.mark.parametrize('interpolation', ['nearest', 'bilinear'])
@pytest.mark.parametrize('kind', ['uint8', 'gray', 'float32', 'border3'])
def test_remap_matches_jax(interpolation, kind):
    """Twin of tests/ops/test_ops_parity.py's remap checks, held to
    vkit_tpu's remap on the same maps."""
    shape = (53, 71) if kind == 'gray' else (53, 71, 3)
    image = _noisy(shape)
    if kind == 'float32':
        image = image.astype(np.float32) / 3
    border = [10.0, 200.0, 55.5] if kind == 'border3' else 7.0
    map_y, map_x = _maps((47, 80), shape[:2])
    ref = np.asarray(JW.remap(jnp.asarray(image), map_y, map_x,
                              interpolation, border))
    got = TW.remap(torch.from_numpy(image), torch.from_numpy(map_y),
                   torch.from_numpy(map_x), interpolation, border)
    assert got.dtype == torch.from_numpy(image).dtype
    assert tuple(got.shape) == ref.shape
    diff = _lsb(ref, got.numpy())
    if interpolation == 'nearest':
        assert diff.max() == 0
    elif kind == 'float32':
        assert diff.max() <= 1e-4
    else:
        assert diff.max() <= 1


def test_remap_f32_nearest_is_batched():
    """remap_f32 keeps the port's batched signature: (N, H, W, C) by (N,
    H', W') maps, each sample by its own maps."""
    images = _noisy((2, 30, 40, 3)).astype(np.float32)
    maps = [_maps((25, 35), (30, 40), seed) for seed in (3, 4)]
    map_y = torch.from_numpy(np.stack([m[0] for m in maps]))
    map_x = torch.from_numpy(np.stack([m[1] for m in maps]))
    got = TW.remap_f32(torch.from_numpy(images), map_y, map_x, 9.0,
                       interpolation='nearest')
    for i in range(2):
        ref = np.asarray(JW.remap_f32(jnp.asarray(images[i]), maps[i][0],
                                      maps[i][1], 'nearest', 9.0))
        np.testing.assert_array_equal(got[i].numpy(), ref)
    with pytest.raises(NotImplementedError):
        TW.remap_f32(torch.from_numpy(images), map_y, map_x, 0.0, 'cubic')


@pytest.mark.parametrize('interpolation', ['nearest', 'bilinear'])
def test_remap_batch_matches_jax(interpolation):
    images = _noisy((3, 40, 50, 3))
    maps = [_maps((36, 44), (40, 50), seed) for seed in (5, 6, 7)]
    map_ys = np.stack([m[0] for m in maps])
    map_xs = np.stack([m[1] for m in maps])
    ref = np.asarray(JW.remap_batch(jnp.asarray(images), map_ys, map_xs,
                                    interpolation, 3.0))
    got = TW.remap_batch(torch.from_numpy(images), map_ys, map_xs,
                         interpolation, 3.0)
    assert got.dtype == torch.uint8
    assert _lsb(ref, got.numpy()).max() <= (0 if interpolation == 'nearest'
                                            else 1)


MATRICES = {
    'affine': np.array([[0.95, 0.2, 5.0], [-0.15, 1.05, -3.0]]),
    'rotate': np.array([[np.cos(0.3), -np.sin(0.3), 20.0],
                        [np.sin(0.3), np.cos(0.3), -10.0]]),
    'perspective': np.array([[1.0, 0.1, 3.0], [0.05, 0.9, 2.0],
                             [3e-4, -2e-4, 1.0]]),
}


@pytest.mark.parametrize('name', sorted(MATRICES))
def test_affine_maps_match_jax(name):
    mat = MATRICES[name]
    ref_y, ref_x = JW.affine_maps(mat, (100, 120))
    got_y, got_x = TW.affine_maps(mat, (100, 120), device='cpu')
    assert got_y.dtype == torch.float32 and tuple(got_y.shape) == (100, 120)
    assert _lsb(ref_y, got_y.numpy()).max() <= AFFINE_MAP_TOL
    assert _lsb(ref_x, got_x.numpy()).max() <= AFFINE_MAP_TOL
    # A tensor matrix builds the maps on its own device.
    again_y, _ = TW.affine_maps(torch.from_numpy(mat), (100, 120))
    assert torch.equal(again_y, got_y)


def test_affine_maps_device_rules():
    """A numpy matrix builds the maps on the card unless the caller asks
    for the CPU, and without a card that raises; warp_affine builds them
    on the image's device, whatever the matrix's."""
    mat = MATRICES['perspective']
    if not torch.cuda.is_available():
        with pytest.raises(convert.DeviceError):
            TW.affine_maps(mat, (100, 120))
    image = torch.from_numpy(_smooth((97, 130, 3)))
    from_numpy = TW.warp_perspective(image, mat, (100, 120))
    from_tensor = TW.warp_perspective(image, torch.from_numpy(mat),
                                      (100, 120))
    assert from_numpy.device.type == 'cpu'
    assert torch.equal(from_numpy, from_tensor)


@pytest.mark.parametrize('interpolation', ['nearest', 'bilinear'])
@pytest.mark.parametrize('name', sorted(MATRICES))
def test_warp_affine_and_perspective_match_jax(name, interpolation):
    mat = MATRICES[name]
    ref_fn, got_fn = ((JW.warp_perspective, TW.warp_perspective)
                      if mat.shape == (3, 3)
                      else (JW.warp_affine, TW.warp_affine))
    for image in (_smooth((97, 130, 3)), _noisy((97, 130, 3)),
                  _noisy((97, 130))):
        ref = np.asarray(ref_fn(jnp.asarray(image), mat, (100, 120),
                                interpolation, 7.0))
        got = got_fn(torch.from_numpy(image), mat, (100, 120),
                     interpolation, 7.0).numpy()
        assert got.shape == ref.shape and got.dtype == np.uint8
        diff = _lsb(ref, got)
        if interpolation == 'nearest':
            assert (diff > 0).mean() <= NEAREST_FLIP_SHARE
        else:
            assert diff.max() <= 1


def test_invert_homography_matches_jax():
    mat = MATRICES['perspective']
    np.testing.assert_array_equal(TW.invert_homography(mat),
                                  JW.invert_homography(mat))


# ---------------------------------------------------------------------------
# Single-image photometric ops.
# ---------------------------------------------------------------------------


def test_equalize_hist_matches_jax():
    for plane in (_smooth((61, 77, 3))[..., 1], _noisy((40, 33)),
                  np.full((20, 30), 77, dtype=np.uint8)):
        ref = np.asarray(JC.equalize_hist(jnp.asarray(plane)))
        got = TC.equalize_hist(torch.from_numpy(plane.copy())).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('sigma', [0.8, 1.5, 3.0])
def test_gaussian_blur_matches_jax(sigma):
    for image in (_smooth((50, 63, 3)), _noisy((50, 63)),
                  _noisy((50, 63, 3)).astype(np.float32)):
        ref = np.asarray(JBlur.gaussian_blur(jnp.asarray(image), sigma))
        got = TBlur.gaussian_blur(torch.from_numpy(image), sigma).numpy()
        assert got.dtype == image.dtype and got.shape == image.shape
        assert _lsb(ref, got).max() <= (1 if image.dtype == np.uint8
                                        else 1e-3)


@pytest.mark.parametrize('ksize', [3, 5, 8])
def test_box_blur_matches_jax(ksize):
    for image in (_noisy((47, 52, 3)), _noisy((47, 52))):
        ref = np.asarray(JBlur.box_blur(jnp.asarray(image), ksize))
        got = TBlur.box_blur(torch.from_numpy(image), ksize).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('quality', [5, 30, 75, 95])
def test_jpeg_quality_matches_jax(quality):
    for image in (_smooth((90, 110, 3)), _noisy((72, 88, 3)),
                  _smooth((61, 79, 3))[..., 0], _noisy((40, 56))):
        ref = np.asarray(JE.jpeg_quality(jnp.asarray(image), quality))
        got = TE.jpeg_quality(torch.from_numpy(image.copy()),
                              quality).numpy()
        assert got.dtype == np.uint8 and got.shape == image.shape
        diff = _lsb(ref, got)
        assert (diff > 0).mean() <= JPEG_QUALITY_SHARE
        assert diff.mean() <= JPEG_QUALITY_MEAN
        assert diff.max() <= JPEG_QUALITY_MAX


@pytest.mark.parametrize('quality', [10, 60, 90])
def test_jpeg_quality_np_matches_jax(quality):
    for image in (_noisy((45, 70, 3)), _smooth((33, 41, 3))[..., 2]):
        np.testing.assert_array_equal(TE.jpeg_quality_np(image, quality),
                                      JE.jpeg_quality_np(image, quality))


@pytest.mark.parametrize('resized', [(31, 47), (8, 8), (60, 97)])
def test_pixelation_matches_jax(resized):
    for image in (_noisy((60, 97, 3)), _smooth((60, 97, 3))[..., 0]):
        ref = np.asarray(JE.pixelation(jnp.asarray(image), resized))
        got = TE.pixelation(torch.from_numpy(image.copy()), resized).numpy()
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# ops/jpeg_exact.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('shape', [(61, 77), (33, 18)])
def test_jpeg_roundtrip_exact_torch_matches_vmapped_jnp(shape):
    """The batched port against the reference's single-image form under
    jax.vmap, as tests/ops/test_ops_parity.py calls it."""
    images = _noisy((3,) + shape + (3,), seed=8)
    qualities = (15, 56, 93)
    luma = np.stack([JE._quality_scaled_table(JE._LUMA_QTABLE, q)
                     for q in qualities]).astype(np.int32)
    chroma = np.stack([JE._quality_scaled_table(JE._CHROMA_QTABLE, q)
                       for q in qualities]).astype(np.int32)
    ref = np.asarray(jax.vmap(JJ.jpeg_roundtrip_exact_jnp)(
        jnp.asarray(images), jnp.asarray(luma), jnp.asarray(chroma)))
    got = TJ.jpeg_roundtrip_exact_torch(torch.from_numpy(images),
                                        torch.from_numpy(luma),
                                        torch.from_numpy(chroma)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_h2v1_fancy_rows_matches_jax():
    sub = np.random.default_rng(9).integers(0, 256, (7, 11))
    np.testing.assert_array_equal(TJ.h2v1_fancy_rows(sub),
                                  JJ.h2v1_fancy_rows(sub))


# ---------------------------------------------------------------------------
# mechanism/batched.py
# ---------------------------------------------------------------------------

POLICIES = {p.name: p for p in random_distortion_factory
            .create_photometric_stage_config().distortion_policies}
DETERMINISTIC = sorted(set(_CATALOG) & set(POLICIES) - RNG_CONSUMING)


@pytest.mark.parametrize('name', DETERMINISTIC)
def test_batch_distort_images_compiled_equals_eager(name):
    """Twin of tests/mechanism/test_compiled_dispatch.py on the
    deterministic catalog names: the compiled name gives the eager
    dispatch's batch."""
    rng = np.random.default_rng(11)
    images = torch.from_numpy(_noisy((3, 48, 64, 3), seed=0))
    configs = [POLICIES[name].sample_config(5, (48, 64), rng)
               for _ in range(3)]
    sig0 = _static_signature(name, configs[0])
    configs = [c if _static_signature(name, c) == sig0 else configs[0]
               for c in configs]
    if name in ('pixelation', 'zoom_in_blur'):
        configs = [configs[0]] * 3
    want = batch_distort_images(name, configs, images, seed=7)
    got = batch_distort_images_compiled(name, configs, images, seed=7)
    assert torch.equal(got, want)


def test_attr_evolve_streak():
    from vkit_tpu_torch.mechanism.batched import attr_evolve_streak

    cfg = POLICIES['line_streak'].sample_config(5, (48, 64),
                                                np.random.default_rng(0))
    evolved = attr_evolve_streak(cfg, alpha=0.25)
    assert evolved.alpha == 0.25 and type(evolved) is type(cfg)
    assert attr.evolve(evolved, alpha=cfg.alpha) == cfg


# ---------------------------------------------------------------------------
# engine/font/atlas.py
# ---------------------------------------------------------------------------


def test_placements_for_text_lines_matches_jax():
    """Twin of tests/ops/test_glyph.py's single-atlas composite: text
    lines laid out by each package's font code, the placement tables equal
    field for field, and the composites within 1 LSB."""
    meta = build_font_collection().font_metas[0]
    ref_entries = _line_entries(meta, JaxRunConfig,
                                jax_plan_text_line_layout,
                                jax_get_glyph_atlas)
    entries = _line_entries(_port_font_meta(meta), TF.FontEngineRunConfig,
                            plan_text_line_layout, get_glyph_atlas)
    ref_pl, ref_tile = jax_placements_for_text_lines(
        [e[:4] for e in ref_entries], bucket=64)
    placements, out_tile = placements_for_text_lines(
        [e[:4] for e in entries], bucket=64)
    assert out_tile == ref_tile
    assert type(placements).__name__ == type(ref_pl).__name__
    for field in ref_pl._fields:
        np.testing.assert_array_equal(getattr(placements, field),
                                      np.asarray(getattr(ref_pl, field)),
                                      err_msg=field)
    canvas = np.full((2, 110, 320, 3), 230, dtype=np.uint8)
    ref = np.asarray(JG.composite_glyphs(
        jnp.asarray(canvas), ref_entries[0][4].tiles, ref_pl,
        out_tile=ref_tile))
    got = TG.composite_glyphs(torch.from_numpy(canvas),
                              torch.from_numpy(entries[0][4].tiles),
                              placements, out_tile=out_tile).numpy()
    assert (ref != 230).any()
    assert _lsb(ref, got).max() <= 1


class _FakeAtlas:
    """tests/engine/test_font.py's growing atlas: snapshot() only."""

    def __init__(self, t=8):
        self.tiles = np.zeros((0, t, t), np.float32)

    def grow(self, k):
        t = self.tiles.shape[1]
        new = np.random.default_rng(len(self.tiles)).random(
            (k, t, t)).astype(np.float32)
        self.tiles = np.concatenate([self.tiles, new])

    def enlarge(self, t):
        old = self.tiles
        self.tiles = np.zeros((old.shape[0], t, t), np.float32)
        self.tiles[:, :old.shape[1], :old.shape[2]] = old

    def snapshot(self):
        return (self.tiles.shape[0], self.tiles.shape[1], self.tiles)


def test_device_tiles_and_resolver_matches_jax():
    """Twin of tests/engine/test_font.py's growth steps (growth inside a
    slab, slab overflow, a tile-rung bump): every id resolves to the
    reference's tile, content and tile size alike.  The buffer's length
    differs on purpose (the reference's capacity slabs)."""
    atlases = {'jax': (_FakeAtlas(), _FakeAtlas()),
               'torch': (_FakeAtlas(), _FakeAtlas())}
    packs = {'jax': JaxAtlasPack(), 'torch': AtlasPack()}
    for key, (a, b) in atlases.items():
        a.grow(3)
        b.grow(5)
        packs[key].global_id(a, 0)
        packs[key].global_id(b, 0)

    def check():
        ref, ref_resolve = packs['jax'].device_tiles_and_resolver()
        got, resolve = packs['torch'].device_tiles_and_resolver(device='cpu')
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        assert got.shape[1:] == ref.shape[1:]
        ref, got = np.asarray(ref), got.numpy()
        for slot, atlas in enumerate(atlases['torch']):
            for local in range(atlas.tiles.shape[0]):
                np.testing.assert_array_equal(
                    got[resolve((slot, local))],
                    ref[ref_resolve((slot, local))])
        return got.shape

    shape0 = check()
    for step in ('grow', 'overflow', 'rung'):
        for a, b in atlases.values():
            if step == 'grow':
                a.grow(10)
            elif step == 'overflow':
                a.grow(80)
            else:
                b.enlarge(20)
                b.grow(1)
        shape = check()
        if step == 'rung':
            assert shape[1] == 24 and shape0[1] == 16


def test_device_tiles_and_resolver_defaults_to_the_card():
    pack = AtlasPack()
    atlas = _FakeAtlas()
    atlas.grow(2)
    pack.global_id(atlas, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pack.device_tiles_and_resolver()


# ---------------------------------------------------------------------------
# utility/profiling.py
# ---------------------------------------------------------------------------


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / 'on')) as prof:
        x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
        (x @ x).sum()
    assert prof is not None
    files = glob.glob(str(tmp_path / 'on' / '*.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('cat') == 'cpu_op' for e in events)
    assert not any(e.get('cat') == 'kernel' for e in events)

    # Without a card, host=False still traces the host.
    with device_trace(str(tmp_path / 'device'), host=False) as prof:
        (x @ x).sum()
    assert len(glob.glob(str(tmp_path / 'device' / '*.json'))) == 1

    with device_trace(str(tmp_path / 'off'), enabled=False) as prof:
        (x @ x).sum()
    assert prof is None
    assert not (tmp_path / 'off').exists()
