"""Glyph and overlay compositing: alpha-blend resampled tiles onto pages.

Port of vkit_tpu/ops/glyph.py ``_resample_weights``, ``composite_glyphs``,
``composite_patches``, ``accumulate_glyph_alpha`` and
``composite_patches_and_alpha``, plus ``GlyphPlacements`` and
``build_placements``, whose twin here keeps the placement table in host
numpy.

Each placement row resamples its atlas tile to its destination box with
bilinear tap-weight products (half-pixel centers, cv2 INTER_LINEAR) and
blends the S x S patch into the page.  The reference walks the table with
``lax.scan``, so overlapping rows blend in table order (z-order).  Here
the patches of a chunk of rows are resampled together in batched matrix
products, and a Python loop blends them into the page in table order,
updating the padded work canvas in place.  Rows with ``valid == 0`` blend
with alpha 0, which leaves the canvas bit-identical, so the loop skips them.

The max-accumulate of ``accumulate_glyph_alpha`` (and of the alpha half of
``composite_patches_and_alpha``) is exact and free of order, so it is one
``scatter_reduce_('amax')`` per chunk of rows instead of a row loop.  Alpha
canvases hold values >= 0, so a row with ``valid == 0`` (alpha 0) changes
nothing there either.
"""
from typing import NamedTuple

import numpy as np
import torch

from .. import convert
from .warp import to_image_dtype

_ROW_CHUNK = 256
# Patch pixels resampled together (bounds the (R, S, S, C) temporaries of
# a chunk when S is a 512-px region tile).
_CHUNK_PIXELS = 1 << 22


def _rows_per_chunk(s: int) -> int:
    return max(1, min(_ROW_CHUNK, _CHUNK_PIXELS // (s * s)))


class GlyphPlacements(NamedTuple):
    """One row per glyph quad (the reference's table).

    Destination boxes use UNPADDED canvas coordinates; `up`/`left` may be
    negative down to -out_tile (the compositor pads the canvas).  Rows with
    ``valid == 0`` are no-ops (bucket padding).  Fields hold numpy arrays on
    the host and tensors once moved to a device (convert.glyph_placements).
    """
    glyph_ids: np.ndarray     # (G,) i32 — atlas tile index
    sample_ids: np.ndarray    # (G,) i32 — batch sample
    ups: np.ndarray           # (G,) i32 — dst box up (canvas coords)
    lefts: np.ndarray         # (G,) i32
    dst_hs: np.ndarray        # (G,) i32 — dst box extents, <= out_tile
    dst_ws: np.ndarray        # (G,) i32
    src_hs: np.ndarray        # (G,) f32 — glyph ink extents inside the tile
    src_ws: np.ndarray        # (G,) f32
    colors: np.ndarray        # (G, C) f32 — blend color per glyph
    valids: np.ndarray        # (G,) f32 in {0, 1}

    @property
    def num_rows(self) -> int:
        return int(self.glyph_ids.shape[0])


def build_placements(rows, num_channels: int = 3,
                     bucket: int = 256) -> GlyphPlacements:
    """Pack host placement rows into a bucket-padded GlyphPlacements of
    numpy arrays (the reference's table, without the device upload).

    ``rows``: iterable of dicts with keys glyph_id, sample_id, up, left,
    dst_h, dst_w, src_h, src_w, color.  The table pads to ``bucket`` or the
    next power of two above the row count."""
    rows = list(rows)
    padded = bucket
    while padded < len(rows):
        padded *= 2

    table = GlyphPlacements(
        glyph_ids=np.zeros(padded, dtype=np.int32),
        sample_ids=np.zeros(padded, dtype=np.int32),
        ups=np.zeros(padded, dtype=np.int32),
        lefts=np.zeros(padded, dtype=np.int32),
        dst_hs=np.ones(padded, dtype=np.int32),
        dst_ws=np.ones(padded, dtype=np.int32),
        src_hs=np.ones(padded, dtype=np.float32),
        src_ws=np.ones(padded, dtype=np.float32),
        colors=np.zeros((padded, num_channels), dtype=np.float32),
        valids=np.zeros(padded, dtype=np.float32),
    )
    keys = (('glyph_ids', 'glyph_id'), ('sample_ids', 'sample_id'),
            ('ups', 'up'), ('lefts', 'left'), ('dst_hs', 'dst_h'),
            ('dst_ws', 'dst_w'), ('src_hs', 'src_h'), ('src_ws', 'src_w'),
            ('colors', 'color'))
    for idx, row in enumerate(rows):
        for field, key in keys:
            getattr(table, field)[idx] = row[key]
        table.valids[idx] = 1.0
    return table


def _resample_weights(out_len: int, tap_len: int, src_extent, dst_extent):
    """(G, out_len, tap_len) bilinear tap weights mapping dst pixel i to
    the source coordinate (i + 0.5) * (src/dst) - 0.5.  Taps outside
    [0, tap_len) drop out; rows at or beyond ``dst_extent`` are zero.
    ``src_extent``: (G,) float32; ``dst_extent``: (G,) int32."""
    device = src_extent.device
    i = torch.arange(out_len, dtype=torch.float32, device=device)
    dst_f = dst_extent.to(torch.float32)
    scale = src_extent / torch.clamp(dst_f, min=1.0)
    src = (i[None, :] + 0.5) * scale[:, None] - 0.5           # (G, S)
    k0f = torch.floor(src)
    frac = src - k0f
    k0 = k0f.to(torch.int32)
    k = torch.arange(tap_len, dtype=torch.int32, device=device)
    weights = (
        (k == k0[..., None]).to(torch.float32) * (1.0 - frac)[..., None]
        + (k == (k0 + 1)[..., None]).to(torch.float32) * frac[..., None]
    )
    row_gate = (i[None, :] < dst_f[:, None]).to(torch.float32)
    return weights * row_gate[..., None]


class _HostRows(NamedTuple):
    order: np.ndarray        # table rows that blend, in table order
    sample_ids: np.ndarray
    ups: np.ndarray
    lefts: np.ndarray


def _host_rows(placements) -> _HostRows:
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    return _HostRows(
        order=np.flatnonzero(host(placements.valids) != 0),
        sample_ids=host(placements.sample_ids).astype(np.int64),
        ups=host(placements.ups).astype(np.int64),
        lefts=host(placements.lefts).astype(np.int64),
    )


def _patch_alphas(tiles, table, rows, s):
    """(R, S, S) clipped alpha patches of table ``rows``."""
    tap = int(tiles.shape[1])
    w_y = _resample_weights(s, tap, table.src_hs[rows], table.dst_hs[rows])
    w_x = _resample_weights(s, tap, table.src_ws[rows], table.dst_ws[rows])
    tile = tiles[table.glyph_ids[rows].to(torch.int64)]
    alpha = torch.matmul(torch.matmul(w_y, tile), w_x.transpose(1, 2))
    alpha = alpha * table.valids[rows][:, None, None]
    return torch.clamp(alpha, 0.0, 1.0), w_y, w_x


def _pad_canvas(canvas, s):
    """float32 copy of (N, H, W, ...) ``canvas`` with ``s`` zero pixels on
    every side, so patches may hang off any edge."""
    n, height, width = canvas.shape[:3]
    work = torch.zeros((n, height + 2 * s, width + 2 * s) + canvas.shape[3:],
                       dtype=torch.float32, device=canvas.device)
    work[:, s:s + height, s:s + width] = canvas.to(torch.float32)
    return work


def _clamped_starts(host, rows, shape, s):
    """(sample, y, x) of table ``rows`` in the padded canvas of ``shape``;
    dynamic_slice semantics: starts clamp into the padded canvas."""
    n, hp, wp = shape
    return (np.clip(host.sample_ids[rows], 0, n - 1),
            np.clip(host.ups[rows] + s, 0, hp - s),
            np.clip(host.lefts[rows] + s, 0, wp - s))


def _accumulate_max(work_a, alpha, sids, ys, xs):
    """work_a[sid, y:y+S, x:x+S] = max(itself, alpha[r]) for every row r in
    one pass.  ``work_a``: (N, Hp, Wp) padded canvas, updated in place."""
    device = work_a.device
    _, hp, wp = work_a.shape
    s = alpha.shape[1]
    span = torch.arange(s, device=device)
    base = torch.as_tensor((sids * hp + ys) * wp + xs, device=device)
    idx = base[:, None, None] + span[:, None] * wp + span[None, :]
    work_a.view(-1).scatter_reduce_(0, idx.reshape(-1), alpha.reshape(-1),
                                    'amax', include_self=True)


def _row_chunks(tiles, placements, device, s, padded_shape):
    """The valid table rows in table order, a chunk at a time: (device
    table, rows, clipped (R, S, S) alphas, w_y, w_x, clamped (samples, ys,
    xs) in the padded canvas)."""
    table = convert.glyph_placements(placements, device)
    host = _host_rows(placements)
    step = _rows_per_chunk(s)
    for c0 in range(0, len(host.order), step):
        chunk = host.order[c0:c0 + step]
        rows = torch.as_tensor(chunk, device=device)
        alpha, w_y, w_x = _patch_alphas(tiles, table, rows, s)
        yield (table, rows, alpha, w_y, w_x,
               _clamped_starts(host, chunk, padded_shape, s))


def _unpad(work, s):
    return work[:, s:work.shape[1] - s, s:work.shape[2] - s]


def _composite(canvas, tiles, placements, s, paint_fn, alpha_canvas=None):
    """Shared scan: blend ``alpha * paint + (1 - alpha) * region`` row by
    row.  ``paint_fn(table, rows, w_y, w_x)`` gives the (R, S, S, C) or
    (R, 1, 1, C) paint of a chunk of rows of the device table.  With
    ``alpha_canvas`` (N, H, W), also max-accumulate each row's alpha into
    it and return (canvas, alpha canvas)."""
    work = _pad_canvas(canvas, s)
    work_a = None if alpha_canvas is None else _pad_canvas(alpha_canvas, s)
    for table, rows, alpha, w_y, w_x, starts in _row_chunks(
            tiles, placements, canvas.device, s, work.shape[:3]):
        if work_a is not None:
            _accumulate_max(work_a, alpha, *starts)
        alpha = alpha[..., None]
        painted = alpha * paint_fn(table, rows, w_y, w_x)   # (R, S, S, C)
        keep = 1.0 - alpha                                  # (R, S, S, 1)
        for k, (sid, y, x) in enumerate(zip(*(a.tolist() for a in starts))):
            region = work[sid, y:y + s, x:x + s]
            region.mul_(keep[k]).add_(painted[k])
    out = to_image_dtype(_unpad(work, s), canvas.dtype)
    return out if work_a is None else (out, _unpad(work_a, s))


def composite_glyphs(canvas, tiles, placements: GlyphPlacements,
                     out_tile: int = 64):
    """Alpha-blend every placement row onto the canvas, in table order.

    ``canvas``: (N, H, W, C) uint8 or float32 tensor; ``tiles``: (V, T, T)
    float32 alpha tensor on the canvas' device; ``placements``: a table of
    numpy arrays or tensors; ``out_tile``: the destination patch size S
    (every dst box within S x S).  Returns a new canvas with the input
    dtype.  Blend per row: out = alpha * color + (1 - alpha) * out."""
    def paint(table, rows, w_y, w_x):
        return table.colors[rows][:, None, None, :]

    return _composite(canvas, tiles, placements, out_tile, paint)


def _patch_paint(tiles_rgb, use_rgbs, device):
    """paint_fn of composite_patches: the resampled RGB patch where
    ``use_rgbs`` selects it, else the row color."""
    use_rgbs = convert.to_tensor(use_rgbs, device, torch.float32)

    def paint(table, rows, w_y, w_x):
        tile_rgb = tiles_rgb[table.glyph_ids[rows].to(torch.int64)]
        rgb = torch.einsum('rst,rtuc,rvu->rsvc', w_y, tile_rgb, w_x)
        use = use_rgbs[rows][:, None, None, None]
        return table.colors[rows][:, None, None, :] * (1.0 - use) + rgb * use

    return paint


def composite_patches(canvas, tiles_alpha, tiles_rgb, use_rgbs,
                      placements: GlyphPlacements, out_tile: int = 128):
    """composite_glyphs with optional per-patch RGB content: ``tiles_rgb``
    (V, T, T, 3) float32 and ``use_rgbs`` (G,) float32 select the resampled
    RGB patch over the row color.  Table order is z-order."""
    return _composite(canvas, tiles_alpha, placements, out_tile,
                      _patch_paint(tiles_rgb, use_rgbs, canvas.device))


def accumulate_glyph_alpha(alpha_canvas, tiles, placements: GlyphPlacements,
                           out_tile: int = 64):
    """Max-accumulate glyph alpha into an (N, H, W) float32 canvas with
    values >= 0 — the text line's ScoreMap (keep_max_value fills) used for
    label rasters and mask thresholds.  Returns a new canvas."""
    work_a = _pad_canvas(alpha_canvas, out_tile)
    for _, _, alpha, _, _, starts in _row_chunks(
            tiles, placements, alpha_canvas.device, out_tile, work_a.shape):
        _accumulate_max(work_a, alpha, *starts)
    return _unpad(work_a, out_tile)


def composite_patches_and_alpha(canvas, alpha_canvas, tiles_alpha, tiles_rgb,
                                use_rgbs, placements: GlyphPlacements,
                                out_tile: int = 128):
    """composite_patches + accumulate_glyph_alpha over the same placement
    rows, each tile's alpha resampled once.  Returns (blended canvas with
    the input dtype, max-accumulated (N, H, W) float32 alpha canvas)."""
    return _composite(canvas, tiles_alpha, placements, out_tile,
                      _patch_paint(tiles_rgb, use_rgbs, canvas.device),
                      alpha_canvas=alpha_canvas)
