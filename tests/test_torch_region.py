"""The parts of the port's text-region stream and char gaussians
(vkit_tpu_torch/ops/region.py, the host half of synth/region.py, the
max-accumulate halves of ops/glyph.py) against vkit_tpu's on the same
inputs, made from a seed with numpy; tests/test_torch_region_stream.py
holds the stream as a whole.  The reference's device halves run through
XLA on the CPU (its row-shift kernels in interpret mode); the port's run
with ``device='cpu'``, where the kernel wrappers take their plain versions.

Tolerances.  Host numbers (regions, boxes, polygons, regression labels,
crop windows) are float64 numpy from the same code: equal, or within 1e-12
where a test says so.  Rasters go through float32 arithmetic that XLA and
PyTorch round differently (fused multiply-adds, reciprocal divisions), and
three thresholds turn a last-bit difference into a whole pixel: the polygon
test of gather_region_windows (``x < cx`` after a divide), the warped alpha
at 0.5 and the accumulated coverage at 0.5, all of which act only on the
outline of a region.  So rasters are held to 1 LSB (images) or a float
tolerance (maps) everywhere except a stated small share of pixels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkit_tpu.ops import glyph as JG
from vkit_tpu.ops import region as JR
from vkit_tpu.synth import RegionStreamConfig as JaxRegionStreamConfig
from vkit_tpu.synth import region as jax_region_mod
from vkit_tpu_torch.ops import glyph as TG
from vkit_tpu_torch.ops import region as TR
from vkit_tpu_torch.synth import RegionStreamConfig
from vkit_tpu_torch.synth import region as region_mod

torch.set_num_threads(1)

# Share of a raster's pixels that may sit on a region outline where one of
# the three thresholds flips (module docstring).
EDGE_SHARE = 2e-3


# ---------------------------------------------------------------------------
# Host planners: the reference's numpy code.
# ---------------------------------------------------------------------------


def _flatten_inputs(seed, count, src_tile):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-180, 180, count)
    scales = rng.uniform(0.4, 2.5, count)
    extents = np.stack([rng.integers(4, src_tile + 1, count),
                        rng.integers(4, src_tile + 1, count)], axis=1)
    return angles, scales, extents


@pytest.mark.parametrize('with_extents', [False, True])
def test_plan_region_flatten_equals_reference(with_extents):
    angles, scales, extents = _flatten_inputs(0, 40, 96)
    extents = extents if with_extents else None
    ref = JR.plan_region_flatten(angles, scales, 96, 128, extents)
    got = TR.plan_region_flatten(angles, scales, 96, 128, extents)
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])


def test_region_flatten_point_map_equals_reference():
    angles, scales, extents = _flatten_inputs(1, 12, 64)
    mats, _ = TR.plan_region_flatten(angles, scales, 64, 128, extents)
    rng = np.random.default_rng(2)
    groups = rng.integers(0, 12, 200)
    points = rng.uniform(0, 64, (200, 2))
    np.testing.assert_array_equal(
        JR.region_flatten_point_map(mats, groups, points),
        TR.region_flatten_point_map(mats, groups, points),
    )


def test_char_regression_encodings_equal_reference():
    rng = np.random.default_rng(3)
    corners = rng.uniform(0, 40, (32, 4, 2))
    centers = corners.mean(axis=1) + rng.uniform(-30, 30, (32, 2)) * (
        rng.random((32, 1)) > 0.7)
    ref = jax_region_mod.char_regression_encodings(corners, centers)
    got = region_mod.char_regression_encodings(corners, centers)
    assert type(got).__name__ == 'CharRegression'
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(ref, field),
                                      getattr(got, field), err_msg=field)


def test_chunk_rows_and_ladders_equal_reference():
    for tile in (64, 128, 192, 256, 384, 512, 640):
        assert region_mod._chunk_rows(tile) == jax_region_mod._chunk_rows(
            tile)
    for size in (1, 64, 65, 200, 512, 513, 700):
        assert region_mod._ladder(size) == jax_region_mod._ladder(size)
    assert tuple(RegionStreamConfig()) == tuple(JaxRegionStreamConfig())


# ---------------------------------------------------------------------------
# Char heatmaps.
# ---------------------------------------------------------------------------


def _char_quads(seed, count, tile):
    """Convex quads: jittered boxes relative to their own tile origin."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(6, tile - 4, count)
    h = rng.uniform(6, tile - 4, count)
    zero = np.zeros(count)
    quads = np.stack([
        np.stack([zero, zero], 1), np.stack([w, zero], 1),
        np.stack([w, h], 1), np.stack([zero, h], 1),
    ], axis=1) + rng.uniform(-2, 2, (count, 4, 2))
    return quads - np.floor(quads.min(axis=1, keepdims=True))


def assert_maps_close(ref, got, tol=1e-5):
    """Float maps within ``tol`` (float32 rounding of a 3-term product, a
    divide and an exp), except where the bump square's border gate flips:
    there the bump is below exp(-0.5 * 2.25^2) < 0.08."""
    diff = np.abs(ref - got)
    assert diff.max() <= 0.08
    assert (diff > tol).sum() <= EDGE_SHARE * diff.size


@pytest.mark.parametrize('tile', [64, 32])
def test_char_heatmaps_match_reference(tile):
    quads = _char_quads(tile, 100, tile)
    ref = np.asarray(JR.batch_char_heatmaps(quads, tile=tile))
    got = TR.batch_char_heatmaps(quads, tile=tile, device='cpu').numpy()
    # The reference pads its tile count to a power of two (128 here).
    assert ref.shape == (128, tile, tile) and got.shape == (100, tile, tile)
    assert got.max() > 0.99
    assert_maps_close(ref[:100], got)
    mats_inv = TR.plan_char_heatmap_mats(quads)
    np.testing.assert_array_equal(JR.plan_char_heatmap_mats(quads), mats_inv)
    tiles = TR.char_heatmap_tiles(
        torch.from_numpy(mats_inv.astype(np.float32)), tile=tile)
    assert torch.equal(tiles, torch.from_numpy(got))


def test_char_heatmap_chunks_equal_one_pass(monkeypatch):
    quads = _char_quads(5, 50, 32)
    whole = TR.batch_char_heatmaps(quads, tile=32, device='cpu')
    monkeypatch.setattr(TR, '_HEATMAP_CHUNK', 16)
    assert torch.equal(TR.batch_char_heatmaps(quads, tile=32, device='cpu'),
                       whole)


# ---------------------------------------------------------------------------
# Max-accumulate and the fused composite (ops/glyph.py).
# ---------------------------------------------------------------------------


def _placement_rows(seed, count, num_tiles, tile, h, w, n, extent):
    """Random placements: overlapping, hanging off every canvas edge, some
    starting beyond the padded canvas (where the reference clamps)."""
    rng = np.random.default_rng(seed)
    rows = []
    for idx in range(count):
        src_h, src_w = rng.integers(4, tile + 1, 2)
        dst_h, dst_w = rng.integers(3, extent + 1, 2)
        rows.append({
            'glyph_id': int(rng.integers(0, num_tiles)),
            'sample_id': idx % n,
            'up': int(rng.integers(-extent - 4, h + extent + 4)),
            'left': int(rng.integers(-extent - 4, w + extent + 4)),
            'dst_h': int(dst_h), 'dst_w': int(dst_w),
            'src_h': float(src_h), 'src_w': float(src_w),
            'color': rng.uniform(0, 255, 3).astype(np.float32),
        })
    # Rows flush with each canvas edge.
    for up, left in ((0, 0), (h - extent, w - extent), (-extent // 2, 5),
                     (7, w - extent // 2)):
        rows.append(dict(rows[0], up=up, left=left, dst_h=extent,
                         dst_w=extent, src_h=float(tile), src_w=float(tile)))
    return rows


@pytest.mark.parametrize('seed', [0, 1])
def test_accumulate_glyph_alpha_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    tiles = rng.random((5, 12, 12), dtype=np.float32)
    canvas = (rng.random((2, 40, 56), dtype=np.float32) * 0.3).astype(
        np.float32)
    rows = _placement_rows(seed, 60, 5, 12, 40, 56, 2, extent=16)
    ref = np.asarray(JG.accumulate_glyph_alpha(
        jnp.asarray(canvas), jnp.asarray(tiles),
        JG.build_placements(rows, bucket=64), out_tile=16,
    ))
    got = TG.accumulate_glyph_alpha(
        torch.from_numpy(canvas), torch.from_numpy(tiles),
        TG.build_placements(rows, bucket=64), out_tile=16,
    ).numpy()
    assert (got > canvas).any()
    # A max of clipped bilinear resamples: only the two tap products round
    # differently.
    assert np.abs(ref - got).max() <= 1e-5


@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
def test_composite_patches_and_alpha_matches_reference(dtype):
    rng = np.random.default_rng(11)
    tiles_a = rng.random((6, 20, 20), dtype=np.float32)
    tiles_rgb = rng.random((6, 20, 20, 3), dtype=np.float32) * 255
    canvas = rng.uniform(0, 255, (2, 40, 56, 3)).astype(dtype)
    alpha = np.zeros((2, 40, 56), np.float32)
    rows = _placement_rows(4, 30, 6, 20, 40, 56, 2, extent=24)
    use_rgbs = (rng.random(64) > 0.3).astype(np.float32)
    ref_img, ref_a = JG.composite_patches_and_alpha(
        jnp.asarray(canvas), jnp.asarray(alpha), jnp.asarray(tiles_a),
        jnp.asarray(tiles_rgb), jnp.asarray(use_rgbs),
        JG.build_placements(rows, bucket=64), out_tile=32,
    )
    got_img, got_a = TG.composite_patches_and_alpha(
        torch.from_numpy(canvas), torch.from_numpy(alpha),
        torch.from_numpy(tiles_a), torch.from_numpy(tiles_rgb), use_rgbs,
        TG.build_placements(rows, bucket=64), out_tile=32,
    )
    ref_img, got_img = np.asarray(ref_img), got_img.numpy()
    assert got_img.dtype == ref_img.dtype
    if dtype == np.uint8:
        assert np.abs(ref_img.astype(int) - got_img.astype(int)).max() <= 1
    else:
        # Many overlapping blends of values up to 255, in table order.
        assert np.abs(ref_img - got_img).max() <= 1e-3
    assert np.abs(np.asarray(ref_a) - got_a.numpy()).max() <= 1e-5
    # The fused form equals the two separate passes.
    assert torch.equal(got_a, TG.accumulate_glyph_alpha(
        torch.from_numpy(alpha), torch.from_numpy(tiles_a),
        TG.build_placements(rows, bucket=64), out_tile=32))
    assert np.array_equal(got_img, TG.composite_patches(
        torch.from_numpy(canvas), torch.from_numpy(tiles_a),
        torch.from_numpy(tiles_rgb), use_rgbs,
        TG.build_placements(rows, bucket=64), out_tile=32).numpy())


def test_composite_row_chunks_equal_one_pass(monkeypatch):
    """The row chunk only groups the resampling; table order decides."""
    rng = np.random.default_rng(12)
    tiles_a = rng.random((4, 16, 16), dtype=np.float32)
    tiles_rgb = rng.random((4, 16, 16, 3), dtype=np.float32) * 255
    canvas = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    alpha = np.zeros((2, 32, 32), np.float32)
    rows = _placement_rows(6, 20, 4, 16, 32, 32, 2, extent=16)
    table = TG.build_placements(rows, bucket=32)

    def run():
        return TG.composite_patches_and_alpha(
            torch.from_numpy(canvas), torch.from_numpy(alpha),
            torch.from_numpy(tiles_a), torch.from_numpy(tiles_rgb),
            np.ones(32, np.float32), table, out_tile=16)

    whole = run()
    monkeypatch.setattr(TG, '_CHUNK_PIXELS', 16 * 16 * 5)
    assert TG._rows_per_chunk(16) == 5
    chunked = run()
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


# ---------------------------------------------------------------------------
# Region windows and the flatten.
# ---------------------------------------------------------------------------


def _window_rows(seed, count, n, height, width, tile):
    rng = np.random.default_rng(seed)
    hs = rng.integers(6, tile + 1, count)
    ws = rng.integers(6, tile + 1, count)
    # Windows anywhere on the page, the last rows and columns included.
    ups = rng.integers(0, height - 4, count)
    lefts = rng.integers(0, width - 4, count)
    sids = rng.integers(0, n, count)
    zero = np.zeros(count)
    box = np.stack([
        np.stack([zero, zero], 1), np.stack([ws - 1.0, zero], 1),
        np.stack([ws - 1.0, hs - 1.0], 1), np.stack([zero, hs - 1.0], 1),
    ], axis=1)
    # Rotated, slightly dilated word polygons about the window center.
    theta = rng.uniform(-0.5, 0.5, count)
    center = box.mean(axis=1, keepdims=True)
    rel = (box - center) * rng.uniform(0.5, 1.1, (count, 1, 1))
    rot = np.stack([
        np.stack([np.cos(theta), -np.sin(theta)], 1),
        np.stack([np.sin(theta), np.cos(theta)], 1),
    ], axis=1)
    quads = np.einsum('rij,rkj->rki', rot, rel) + center
    return (sids.astype(np.int32), ups.astype(np.int32),
            lefts.astype(np.int32), hs.astype(np.float32),
            ws.astype(np.float32), quads.astype(np.float32))


@pytest.mark.parametrize('tile', [32, 64])
def test_gather_region_windows_matches_reference(tile):
    rng = np.random.default_rng(20 + tile)
    n, height, width = 3, 96, 112
    images = rng.integers(0, 256, (n, height, width, 3), dtype=np.uint8)
    active = (rng.random((n, height, width)) > 0.2).astype(np.uint8)
    rows = _window_rows(tile, 40, n, height, width, tile)
    ref = np.asarray(JR.gather_region_windows(
        jnp.asarray(images), jnp.asarray(active), *rows, tile=tile))
    got = TR.gather_region_windows(
        torch.from_numpy(images), torch.from_numpy(active), *rows,
        tile=tile).numpy()
    assert got.shape == (40, tile, tile, 4) and got.dtype == np.float32
    # rgb: a copy gated to the window extent, exact.
    np.testing.assert_array_equal(ref[..., :3], got[..., :3])
    assert (got[..., 3] > 0).any() and (got[..., 3] == 0).any()
    # alpha: 0 / 1; only a pixel whose center lies on a polygon edge to the
    # last float32 bit may flip.
    flips = (ref[..., 3] != got[..., 3]).sum()
    assert flips <= EDGE_SHARE * ref[..., 3].size


def _flatten_case(seed, count, src_tile, quadrant0):
    rng = np.random.default_rng(seed)
    patches = rng.uniform(0, 255, (count, src_tile, src_tile, 4)).astype(
        np.float32)
    span = 40 if quadrant0 else 180
    angles = rng.uniform(-span, span, count)
    scales = rng.uniform(0.6, 1.6, count)
    extents = np.stack([rng.integers(8, src_tile + 1, count),
                        rng.integers(8, src_tile + 1, count)], axis=1)
    return patches, angles, scales, extents


@pytest.mark.parametrize('quadrant0', [True, False])
def test_batch_flatten_regions_matches_reference(quadrant0):
    patches, angles, scales, extents = _flatten_case(30, 10, 64, quadrant0)
    ref, ref_ext, ref_mats = JR.batch_flatten_regions(
        jnp.asarray(patches), angles, scales, 128,
        content_extents=extents, return_mats=True)
    got, got_ext, got_mats = TR.batch_flatten_regions(
        torch.from_numpy(patches), angles, scales, 128,
        content_extents=extents, return_mats=True)
    np.testing.assert_array_equal(ref_ext, got_ext)
    np.testing.assert_array_equal(ref_mats, got_mats)
    assert got.shape == (10, 128, 128, 4) and got.dtype == torch.float32
    # The affine route's tolerance in tests/test_torch_warp.py: the same
    # taps and hat weights, blended in float32 by XLA and by PyTorch.
    assert np.abs(np.asarray(ref) - got.numpy()).max() <= 1e-3
    assert got.numpy().max() > 100


def test_batch_flatten_regions_defaults_match_reference():
    """No content extents, no mats: the full tile is the content."""
    patches, angles, scales, _ = _flatten_case(31, 6, 32, True)
    ref, ref_ext = JR.batch_flatten_regions(jnp.asarray(patches), angles,
                                            scales, 64, border_value=7.0)
    got, got_ext = TR.batch_flatten_regions(torch.from_numpy(patches),
                                            angles, scales, 64,
                                            border_value=7.0)
    np.testing.assert_array_equal(ref_ext, got_ext)
    assert np.abs(np.asarray(ref) - got.numpy()).max() <= 1e-3


def test_flatten_pad_rows_do_not_change_real_rows():
    """The reference pads a chunk with identity rows (angle 0, scale 1,
    extent 1) up to a power of two; the port flattens the real rows only.
    A row's plan depends on no other row, so the outputs are bit-equal."""
    patches, angles, scales, extents = _flatten_case(32, 5, 64, False)
    alone, _ = TR.batch_flatten_regions(
        torch.from_numpy(patches), angles, scales, 128,
        content_extents=extents)
    padded, _ = TR.batch_flatten_regions(
        torch.from_numpy(np.concatenate([patches, np.zeros_like(patches[:3])])),
        np.concatenate([angles, np.zeros(3)]),
        np.concatenate([scales, np.ones(3)]), 128,
        content_extents=np.concatenate([extents, np.ones((3, 2), np.int64)]))
    assert torch.equal(alone, padded[:5])
