"""The port's glyph and overlay compositor (vkit_tpu_torch/ops/glyph.py) and
atlas tiles (vkit_tpu_torch/engine/font/atlas.py) against vkit_tpu on the
same tables."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.engine.fixtures import build_font_collection
from vkit_tpu.engine.font import FontEngineRunConfig
from vkit_tpu.engine.font.atlas import (
    AtlasPack,
    get_glyph_atlas,
    plan_text_line_layout,
)
from vkit_tpu.engine.font.atlas import pack_placements as jax_pack_placements
from vkit_tpu.ops import glyph as JG
from vkit_tpu_torch.engine.font.atlas import (
    device_tiles_and_resolver,
    pack_placements,
)
from vkit_tpu_torch.ops import glyph as TG

torch.set_num_threads(1)


def _random_rows(seed, count, num_tiles, tile, h, w, n, extent=17):
    rng = np.random.default_rng(seed)
    rows = []
    for idx in range(count):
        src_h, src_w = rng.integers(4, tile + 1, 2)
        dst_h, dst_w = rng.integers(3, extent, 2)
        rows.append({
            'glyph_id': int(rng.integers(0, num_tiles)),
            'sample_id': idx % n,
            # Rows hang off every edge, and some start beyond the padded
            # canvas, where the reference clamps the slice start.
            'up': int(rng.integers(-extent - 4, h + extent + 4)),
            'left': int(rng.integers(-extent - 4, w + extent + 4)),
            'dst_h': int(dst_h), 'dst_w': int(dst_w),
            'src_h': float(src_h), 'src_w': float(src_w),
            'color': rng.uniform(0, 255, 3).astype(np.float32),
        })
    return rows


def test_build_placements_matches_jax():
    rows = _random_rows(0, 11, 5, 12, 48, 64, 2)
    ref = JG.build_placements(rows, bucket=8)
    got = TG.build_placements(rows, bucket=8)
    for field in ref._fields:
        a, b = np.asarray(getattr(ref, field)), getattr(got, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_resample_weights_match_jax():
    src = np.asarray([4.0, 7.0, 12.0, 3.0], np.float32)
    dst = np.asarray([3, 9, 16, 1], np.int32)
    got = TG._resample_weights(16, 12, torch.from_numpy(src),
                               torch.from_numpy(dst)).numpy()
    for i in range(len(src)):
        ref = np.asarray(JG._resample_weights(
            16, 12, jnp.float32(src[i]), jnp.int32(dst[i])
        ))
        assert np.array_equal(ref, got[i])


@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
@pytest.mark.parametrize('seed', [0, 1])
def test_composite_glyphs_matches_jax(seed, dtype):
    rng = np.random.default_rng(100 + seed)
    tiles = rng.random((5, 12, 12), dtype=np.float32)
    canvas = rng.integers(0, 256, (2, 48, 64, 3)).astype(dtype)
    # Many overlapping rows: table order (z-order) decides the result.
    rows = _random_rows(seed, 60, 5, 12, 48, 64, 2)
    placements = JG.build_placements(rows, bucket=64)
    ref = np.asarray(JG.composite_glyphs(
        jnp.asarray(canvas), jnp.asarray(tiles), placements, out_tile=16
    ))
    got = TG.composite_glyphs(
        torch.from_numpy(canvas), torch.from_numpy(tiles),
        TG.build_placements(rows, bucket=64), out_tile=16,
    ).numpy()
    assert got.dtype == ref.dtype
    if dtype == np.uint8:
        assert np.abs(ref.astype(int) - got.astype(int)).max() <= 1
    else:
        assert np.abs(ref - got).max() <= 1e-3


def test_composite_patches_matches_jax():
    rng = np.random.default_rng(7)
    tiles_a = rng.random((6, 20, 20), dtype=np.float32)
    tiles_rgb = (rng.random((6, 20, 20, 3), dtype=np.float32) * 255)
    use_rgbs = (rng.random(8) > 0.5).astype(np.float32)
    canvas = rng.uniform(0, 255, (2, 40, 56, 3)).astype(np.float32)
    rows = _random_rows(3, 7, 6, 20, 40, 56, 2, extent=25)
    placements = JG.build_placements(rows, bucket=8)
    ref = np.asarray(JG.composite_patches(
        jnp.asarray(canvas), jnp.asarray(tiles_a), jnp.asarray(tiles_rgb),
        jnp.asarray(use_rgbs), placements, out_tile=32,
    ))
    got = TG.composite_patches(
        torch.from_numpy(canvas), torch.from_numpy(tiles_a),
        torch.from_numpy(tiles_rgb), use_rgbs,
        TG.build_placements(rows, bucket=8), out_tile=32,
    ).numpy()
    assert np.abs(ref - got).max() <= 1e-3


def test_invalid_rows_leave_canvas_untouched():
    canvas = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(
        2, 8, 8, 3)
    tiles = torch.ones((1, 4, 4))
    table = TG.build_placements([], bucket=8)
    out = TG.composite_glyphs(canvas, tiles, table, out_tile=8)
    assert torch.equal(out, canvas)


def test_pack_placements_matches_jax_composite():
    """Text lines through both atlas paths: the port resolves ids with the
    host tile array, the reference with its device slabs; the composited
    pages agree."""
    variant = build_font_collection().font_metas[0].get_font_variant(0)
    pack = AtlasPack()
    entries = []
    for idx, (text, up, left) in enumerate([
        ('Hello World', 4, 6), ('pack my box', 40, 30), ('0123 jugs', 70, 2),
    ]):
        run_config = FontEngineRunConfig(
            height=28, width=300, chars=list(text), font_variant=variant,
        )
        layout = plan_text_line_layout(run_config, np.random.default_rng(3))
        assert layout is not None
        entries.append((layout, (up, left), idx % 2, (20, 30, 180),
                        get_glyph_atlas(run_config)))
    canvas = np.full((2, 110, 320, 3), 230, dtype=np.uint8)

    ref_pl, ref_tiles, ref_tile = jax_pack_placements(entries, pack,
                                                      bucket=64)
    ref = np.asarray(JG.composite_glyphs(jnp.asarray(canvas), ref_tiles,
                                         ref_pl, out_tile=ref_tile))
    placements, tiles, out_tile = pack_placements(entries, pack, bucket=64)
    assert out_tile == ref_tile
    assert isinstance(tiles, torch.Tensor)
    got = TG.composite_glyphs(torch.from_numpy(canvas), tiles, placements,
                              out_tile=out_tile).numpy()
    assert (ref != 230).any()
    assert np.abs(ref.astype(int) - got.astype(int)).max() <= 1
    # The device tile copy is cached against the pack's state.
    again, _ = device_tiles_and_resolver(pack, 'cpu')
    assert again is tiles
