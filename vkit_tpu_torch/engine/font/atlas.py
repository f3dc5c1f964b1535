"""Glyph atlas tiles on the device, and the placement table that indexes them.

Port of vkit_tpu/engine/font/atlas.py's device half.  The tile array is the
host ``AtlasPack.tiles_and_resolver()`` build, uploaded once per pack state
and cached per (pack, device); ``pack_placements`` resolves glyph ids with
that same resolver.  (The reference's ``device_tiles_and_resolver`` lays
tiles out in capacity slabs for its compiled signature; its ids do not
index the host array, and it allocates jax arrays, so the port does not
call it.  Tile contents are identical, so composites match.)
"""
import threading
import weakref
from typing import Sequence, Tuple

import numpy as np

from vkit_tpu.engine.font.atlas import (
    AtlasPack,
    GlyphAtlas,
    TextLineLayout,
    _quantize_out_tile,
)

from ... import convert
from ...ops.glyph import build_placements

_TILE_CACHE: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()
_TILE_CACHE_LOCK = threading.Lock()


def device_tiles_and_resolver(pack: AtlasPack, device):
    """(tiles (V, T, T) float32 tensor on ``device``, resolver mapping
    (slot, local_id) -> tile index).  Re-uploads only when the pack grew."""
    host_tiles, resolver = pack.tiles_and_resolver()
    device = convert.resolve_device(device)
    with _TILE_CACHE_LOCK:
        per_device = _TILE_CACHE.setdefault(pack, {})
        cached = per_device.get(device)
        if cached is None or cached[0] is not host_tiles:
            cached = (host_tiles, convert.atlas_tiles(host_tiles, device))
            per_device[device] = cached
    return cached[1], resolver


def pack_placements(
    entries: Sequence[Tuple[TextLineLayout, Tuple[int, int], int,
                            Tuple[int, int, int], GlyphAtlas]],
    pack: AtlasPack,
    bucket: int = 256,
    device='cpu',
):
    """Multi-atlas placement table: entries carry the atlas each layout's
    glyph ids index into.  Returns (GlyphPlacements of numpy arrays,
    device tiles, out_tile)."""
    keyed_rows = []
    max_extent = 1
    for layout, (page_up, page_left), sample_id, color, atlas in entries:
        for cb, gid, src_h, src_w in zip(
            layout.char_boxes, layout.glyph_ids,
            layout.src_hs, layout.src_ws,
        ):
            keyed_rows.append((pack.global_id(atlas, gid), {
                'sample_id': sample_id,
                'up': page_up + cb.up,
                'left': page_left + cb.left,
                'dst_h': cb.height,
                'dst_w': cb.width,
                'src_h': float(src_h),
                'src_w': float(src_w),
                'color': np.asarray(color, dtype=np.float32),
            }))
            max_extent = max(max_extent, cb.height, cb.width)

    tiles, resolve = device_tiles_and_resolver(pack, device)
    rows = []
    for key, row in keyed_rows:
        row['glyph_id'] = resolve(key)
        rows.append(row)

    out_tile = _quantize_out_tile(max_extent)
    return build_placements(rows, num_channels=3, bucket=bucket), tiles, \
        out_tile
