"""Glyph and overlay compositing: alpha-blend resampled tiles onto pages.

Port of vkit_tpu/ops/glyph.py ``_resample_weights``, ``composite_glyphs``
and ``composite_patches``, plus ``build_placements``, whose twin here keeps
the placement table in host numpy.

Each placement row resamples its atlas tile to its destination box with
bilinear tap-weight products (half-pixel centers, cv2 INTER_LINEAR) and
blends the S x S patch into the page.  The reference walks the table with
``lax.scan``, so overlapping rows blend in table order (z-order).  Here
the patches of a chunk of rows are resampled together in batched matrix
products, and a Python loop blends them into the page in table order,
updating the padded work canvas in place.  Rows with ``valid == 0`` blend
with alpha 0, which leaves the canvas bit-identical, so the loop skips them.
"""
from typing import NamedTuple

import numpy as np
import torch

from vkit_tpu.ops.glyph import GlyphPlacements

from .. import convert
from .warp import to_image_dtype

_ROW_CHUNK = 256


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


def _composite(canvas, tiles, placements, s, paint_fn):
    """Shared scan: blend ``alpha * paint + (1 - alpha) * region`` row by
    row.  ``paint_fn(table, rows, w_y, w_x)`` gives the (R, S, S, C) or
    (R, 1, 1, C) paint of a chunk of rows of the device table."""
    n, height, width, channels = canvas.shape
    device = canvas.device
    orig_dtype = canvas.dtype
    work = torch.zeros((n, height + 2 * s, width + 2 * s, channels),
                       dtype=torch.float32, device=device)
    work[:, s:s + height, s:s + width] = canvas.to(torch.float32)
    table = convert.glyph_placements(placements, device)
    host = _host_rows(placements)
    hp, wp = work.shape[1], work.shape[2]

    for c0 in range(0, len(host.order), _ROW_CHUNK):
        chunk = host.order[c0:c0 + _ROW_CHUNK]
        rows = torch.as_tensor(chunk, device=device)
        alpha, w_y, w_x = _patch_alphas(tiles, table, rows, s)
        alpha = alpha[..., None]
        painted = alpha * paint_fn(table, rows, w_y, w_x)   # (R, S, S, C)
        keep = 1.0 - alpha                                  # (R, S, S, 1)
        for k, row in enumerate(chunk):
            # dynamic_slice semantics: starts clamp into the padded canvas.
            sid = min(max(int(host.sample_ids[row]), 0), n - 1)
            y = min(max(int(host.ups[row]) + s, 0), hp - s)
            x = min(max(int(host.lefts[row]) + s, 0), wp - s)
            region = work[sid, y:y + s, x:x + s]
            region.mul_(keep[k]).add_(painted[k])

    return to_image_dtype(work[:, s:s + height, s:s + width], orig_dtype)


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


def composite_patches(canvas, tiles_alpha, tiles_rgb, use_rgbs,
                      placements: GlyphPlacements, out_tile: int = 128):
    """composite_glyphs with optional per-patch RGB content: ``tiles_rgb``
    (V, T, T, 3) float32 and ``use_rgbs`` (G,) float32 select the resampled
    RGB patch over the row color.  Table order is z-order."""
    use_rgbs = convert.to_tensor(use_rgbs, canvas.device, torch.float32)

    def paint(table, rows, w_y, w_x):
        tile_rgb = tiles_rgb[table.glyph_ids[rows].to(torch.int64)]
        rgb = torch.einsum('rst,rtuc,rvu->rsvc', w_y, tile_rgb, w_x)
        use = use_rgbs[rows][:, None, None, None]
        return table.colors[rows][:, None, None, :] * (1.0 - use) + rgb * use

    return _composite(canvas, tiles_alpha, placements, out_tile, paint)
