"""Adaptive-scaling text-region stream: flatten -> stack -> label -> crop.

Port of vkit_tpu/synth/region.py.  A tensor-first post-pass over
SynthBatchResult batches producing the other half of the training output
family — stacked region pages with char-level regression labels and region
crops:

  1. Per page, chars group under their word polygon (the synth stream's
     text regions); each region gets a flattening angle (undo the word's
     post-warp orientation) and an adaptive scale (target char height /
     the region's median char height).
  2. The flatten is planned on the host first: rotate+scale composed
     into one affine per region, each region's source tile from its
     window and its destination tile from its own flattened extent; char
     polygons co-transform analytically through the same mats in one
     einsum per chunk.
  3. Flattened extents shelf-pack onto square canvases (pinwheel
     background).  Then the regions of each (source tile, destination
     tile) group gather, flatten (ops/region.batch_flatten_regions, on the
     two-shear warp and its row-shift kernels) and composite
     (ops/glyph.composite_patches_and_alpha) a chunk at a time, so the
     card holds one chunk's tiles at once.
  4. Labels: per-char gaussian score maps render on the device
     (ops/region.batch_char_heatmaps) and the char regression encodings
     (up-left offsets, clockwise angle distribution, corner distances)
     compute vectorized over every stacked char at once.
  5. Optional region crops window the stacked pages through the same
     crop extractor the synth stream uses.

The host half (configs, result types, ``collect_regions``, the regression
encodings, ``_chunk_rows``) is the reference's own numpy code, so regions,
boxes, polygons, labels and crop windows equal the reference's from the
same rng.  ``stack_text_regions`` is rewritten on torch tensors; it drops
the reference's power-of-two row pads (XLA program-set bounds: padded rows
never reach an output) but keeps the page count padded to ``m_pad``, which
``keep_on_device`` callers see.
"""
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
from numpy.random import Generator as RandomGenerator

from ..element import Box, Polygon

TWO_PI = 2.0 * math.pi

_SRC_LADDER = (64, 128, 192, 256, 384, 512)


class RegionStreamConfig(NamedTuple):
    """Knobs of the adaptive-scaling output family.

    ``page_size``: static stacked-canvas side (one compiled program).
    ``target_char_height``: the adaptive-scaling target — every region
    resizes so its median char height lands here (the reference's
    text_region_resize_char_height_median sampling collapses to its
    midpoint by default).
    """
    page_size: int = 640
    target_char_height: int = 36
    page_pad: int = 10
    region_pad: int = 2
    dilate_ratio: float = 0.1
    dst_tile_max: int = 512
    gaussian_tile: int = 64
    num_crops_per_page: int = 0
    crop_size: int = 320


class CharRegression(NamedTuple):
    """Vectorized char regression labels for ONE stacked page — the
    model-facing encodings of PageCharRegressionLabel
    (page_text_region_label.py:227-234), one row per char centroid."""
    label_points_yx: np.ndarray       # (G, 2) f64 — centroid label points
    corners_xy: np.ndarray            # (G, 4, 2) f64 — char quad corners
    up_left_offsets_yx: np.ndarray    # (G, 2) f64
    angle_distributions: np.ndarray   # (G, 4) f64, normalized clockwise
    distances: np.ndarray             # (G, 4) f64
    valids: np.ndarray                # (G,) bool — point inside its quad


class RegionBatchResult(NamedTuple):
    """Stacked region pages + labels.

    With ``keep_on_device`` the raster fields are DEVICE arrays padded to
    a power-of-two page count (static compiled shapes); ``num_pages`` is
    the real count and rows beyond it are blank canvases.  Host-fetched
    results are sliced to the real count and ``num_pages`` matches
    ``len(images)``."""
    images: np.ndarray                 # (M, S, S, 3) uint8 stacked pages
    active_masks: np.ndarray           # (M, S, S) uint8
    gaussian_maps: np.ndarray          # (M, S, S) float32
    region_boxes: Sequence[List[Box]]          # per stacked page
    char_polygons: Sequence[List[Polygon]]     # per stacked page
    regression: Sequence[CharRegression]       # per stacked page
    crop_images: Optional[np.ndarray] = None   # (K, C, C, 3) uint8
    crop_gaussians: Optional[np.ndarray] = None  # (K, C, C) float32
    crop_active: Optional[np.ndarray] = None     # (K, C, C) uint8
    crop_page_ids: Optional[np.ndarray] = None   # (K,) int32
    num_pages: int = 0
    num_crops: int = 0


def char_regression_encodings(
    corners_xy: np.ndarray,
    label_points_xy: np.ndarray,
) -> CharRegression:
    """All regression encodings in one vectorized pass.

    The per-object twin is QuadGeometry (page_text_region_label.py:62-81):
    per-corner distances, clockwise corner-angle deltas (summing to 2*pi
    iff the label point is interior), the normalized angle distribution,
    and the up-left offset."""
    corners = np.asarray(corners_xy, dtype=np.float64).reshape(-1, 4, 2)
    pts = np.asarray(label_points_xy, dtype=np.float64).reshape(-1, 2)
    offsets = corners - pts[:, None, :]                    # (G, 4, 2) xy
    distances = np.hypot(offsets[..., 0], offsets[..., 1])  # (G, 4)
    thetas = np.mod(np.arctan2(offsets[..., 1], offsets[..., 0]), TWO_PI)
    deltas = np.mod(
        np.roll(thetas, -1, axis=1) - thetas + math.pi, TWO_PI
    ) - math.pi
    deltas = np.where(deltas < 0, deltas + TWO_PI, deltas)  # clockwise
    total = deltas.sum(axis=1)
    valids = np.isclose(total, TWO_PI, rtol=0.012)
    sums = deltas.sum(axis=1, keepdims=True)
    with np.errstate(invalid='ignore', divide='ignore'):
        dist = np.where(sums > 0, deltas / sums, 0.25)
    return CharRegression(
        label_points_yx=pts[:, ::-1].copy(),
        corners_xy=corners,
        up_left_offsets_yx=offsets[:, 0, ::-1].copy(),
        angle_distributions=dist,
        distances=distances,
        valids=valids,
    )


def _assign_chars_to_words(
    word_polygons: Sequence[Polygon],
    char_centroids_xy: np.ndarray,
) -> List[List[int]]:
    """Char -> word grouping by centroid-in-bbox (PageTextRegionStep.
    _assign_chars semantics: each char joins the region containing it;
    unmatched chars join the nearest region center).

    ``char_centroids_xy``: (G, 2) xy centroids (vectorized upstream —
    a per-Polygon loop here was the collect-host hot spot)."""
    if not word_polygons:
        return []
    boxes = np.asarray([
        [p.np_xy[:, 1].min(), p.np_xy[:, 1].max(),
         p.np_xy[:, 0].min(), p.np_xy[:, 0].max()]
        for p in word_polygons
    ])  # (W, 4) up/down/left/right
    centers = np.stack([
        (boxes[:, 0] + boxes[:, 1]) / 2, (boxes[:, 2] + boxes[:, 3]) / 2,
    ], axis=1)                                             # (W, 2) yx
    groups: List[List[int]] = [[] for _ in word_polygons]
    if not len(char_centroids_xy):
        return groups
    cxy = np.asarray(char_centroids_xy)                    # (G, 2) xy
    inside = (
        (cxy[:, 1][:, None] >= boxes[None, :, 0] - 0.5)
        & (cxy[:, 1][:, None] <= boxes[None, :, 1] + 0.5)
        & (cxy[:, 0][:, None] >= boxes[None, :, 2] - 0.5)
        & (cxy[:, 0][:, None] <= boxes[None, :, 3] + 0.5)
    )                                                      # (G, W)
    d2 = (
        (cxy[:, 1][:, None] - centers[None, :, 0]) ** 2
        + (cxy[:, 0][:, None] - centers[None, :, 1]) ** 2
    )
    pick = np.where(inside, d2, np.inf).argmin(axis=1)
    none_inside = ~inside.any(axis=1)
    pick[none_inside] = d2[none_inside].argmin(axis=1)
    for char_idx, word_idx in enumerate(pick):
        groups[int(word_idx)].append(char_idx)
    return groups


def _flatten_angle_deg(polygon: Polygon) -> float:
    """Rotation undoing the word's orientation (its up edge p0 -> p1)."""
    xy = polygon.np_xy
    dx = float(xy[1, 0] - xy[0, 0])
    dy = float(xy[1, 1] - xy[0, 1])
    if abs(dx) < 1e-9 and abs(dy) < 1e-9:
        return 0.0
    return -math.degrees(math.atan2(dy, dx))


class _Region(NamedTuple):
    page_id: int
    window: Box          # source window on the synth page
    angle_deg: float
    scale: float
    char_idxs: List[int]
    poly_xy: np.ndarray  # word polygon (page coords) masking the region


def _ladder(size: int) -> int:
    for t in _SRC_LADDER:
        if size <= t:
            return t
    return ((size + 127) // 128) * 128


def collect_regions(
    result,
    config: RegionStreamConfig,
) -> List[_Region]:
    """Plan one flattenable region per word that owns >= 1 char."""
    regions: List[_Region] = []
    page_h, page_w = result.images.shape[1:3]
    quads_per_page = getattr(result, 'char_quads', None)
    for pid, (words, chars) in enumerate(
        zip(result.word_polygons, result.char_polygons)
    ):
        # Vectorized char geometry: the raw (G, 4, 2) quads when the
        # synth batch carries them (20k+ per-Polygon np calls per batch
        # otherwise — the round-5 collect-host hot spot).
        quads = quads_per_page[pid] if quads_per_page is not None else None
        if quads is None and chars:
            quads = np.stack([c.np_xy[:4] for c in chars])
        if quads is not None and len(quads):
            centroids_xy = quads.mean(axis=1)
            h_left = np.hypot(quads[:, 3, 0] - quads[:, 0, 0],
                              quads[:, 3, 1] - quads[:, 0, 1])
            h_right = np.hypot(quads[:, 2, 0] - quads[:, 1, 0],
                               quads[:, 2, 1] - quads[:, 1, 1])
            heights_all = (h_left + h_right) / 2.0
        else:
            centroids_xy = np.zeros((0, 2))
            heights_all = np.zeros((0,))
        groups = _assign_chars_to_words(words, centroids_xy)
        for word_idx, char_idxs in enumerate(groups):
            if not char_idxs:
                continue
            xy = words[word_idx].np_xy
            up = float(xy[:, 1].min())
            down = float(xy[:, 1].max())
            left = float(xy[:, 0].min())
            right = float(xy[:, 0].max())
            pad = config.dilate_ratio * max(down - up, right - left) / 2
            window = Box(
                up=int(max(math.floor(up - pad), 0)),
                down=int(min(math.ceil(down + pad), page_h - 1)),
                left=int(max(math.floor(left - pad), 0)),
                right=int(min(math.ceil(right + pad), page_w - 1)),
            )
            if window.height < 2 or window.width < 2:
                continue
            median = float(np.median(heights_all[char_idxs]))
            if median < 1.0:
                continue
            scale = config.target_char_height / median
            # Bound the flattened extent by the tile budget AND the packer
            # slot (usable canvas minus inner pads): the packer clamps its
            # slot to the usable canvas, so an extent larger than that
            # would overpaint neighboring regions on the same shelf.
            span = math.hypot(window.height, window.width)
            usable = config.page_size - 2 * config.page_pad
            cap = min(config.dst_tile_max,
                      usable - 2 * config.region_pad)
            limit = (cap - 2) / max(span, 1.0)
            scale = float(min(scale, limit))
            if scale <= 0:
                continue
            regions.append(_Region(
                page_id=pid, window=window,
                angle_deg=_flatten_angle_deg(words[word_idx]),
                scale=scale, char_idxs=char_idxs,
                poly_xy=xy.astype(np.float64),
            ))
    return regions


_DST_TILE_LADDER = (128, 256, 512)

# Per-chunk budget for the flatten pass intermediate (~rows x tile x
# window floats); tests lower it to force the multi-chunk path on small
# fixtures.
_CHUNK_BUDGET_BYTES = 1 << 30


def _chunk_rows(tile: int) -> int:
    """Power-of-two region rows per flatten/gather program call."""
    rows = _CHUNK_BUDGET_BYTES // (tile * 12 * 1024)
    r = 64
    while r * 2 <= rows and r < 1024:
        r *= 2
    return r


def _dst_tile(need: int, config: RegionStreamConfig) -> int:
    """The destination tile of a region whose flattened extent needs
    ``need`` px: the least rung of the ladder that holds it."""
    for cand in _DST_TILE_LADDER:
        if need <= cand <= config.dst_tile_max:
            return cand
    return config.dst_tile_max


def _flatten_rows(tile: int, dst_tile: int) -> int:
    """Region rows per gather/flatten/composite call: _chunk_rows(tile),
    halved (to no fewer than 64) while the chunk's float32 rgba
    destination tiles would pass the chunk budget."""
    rows = _chunk_rows(tile)
    while rows > 64 and rows * dst_tile * dst_tile * 16 > _CHUNK_BUDGET_BYTES:
        rows //= 2
    return rows


def stack_text_regions(
    result,
    config: RegionStreamConfig,
    rng: RandomGenerator,
    keep_on_device: bool = False,
    timer=None,
    device='cuda',
) -> Optional[RegionBatchResult]:
    """The full adaptive-scaling post-pass over one SynthBatchResult.

    Device-resident: region windows gather on ``device``
    (ops/region.gather_region_windows), flatten, composite, label and
    crop there too; only the training outputs fetch (or nothing at all
    with ``keep_on_device``).  ``result``'s rasters may be numpy arrays or
    tensors.  With ``keep_on_device`` the stacked pages stay tensors padded
    to a power-of-two page count (rows beyond ``num_pages`` are blank
    canvases); crop tensors hold exactly ``num_crops`` rows.

    Returns None when the batch carries no usable text region."""
    import torch

    from .. import convert
    from ..geometry.packing import pack_rectangles
    from ..ops.glyph import build_placements, composite_patches_and_alpha
    from ..ops.region import (
        batch_flatten_regions,
        gather_region_windows,
        plan_region_flatten,
        region_flatten_point_map,
    )
    from ..pipeline.text_detection.page_text_region import (
        build_background_image_for_stacking,
    )
    from ..utility import profiling
    from .device import _char_gaussian_maps, _extract_crops_program, _spans

    device = convert.resolve_device(device)
    measure = _spans(timer, device)

    with measure('region.collect-host'):
        regions = collect_regions(result, config)
    if not regions:
        return None
    profiling.count('synth.regions', len(regions))

    images_dev = convert.to_tensor(result.images, device)
    active_dev = convert.to_tensor(result.active_masks, device)

    # ------------------------------------------------------------------
    # Flatten plan, on the host: each region's source tile (the ladder
    # over its window) and destination tile (the ladder over its own
    # flattened extent), its forward mat, extent and mapped char polygons.
    # ------------------------------------------------------------------
    src_tiles = np.asarray([
        _ladder(max(region.window.height, region.window.width))
        for region in regions
    ])
    angles_all = np.asarray([region.angle_deg for region in regions])
    scales_all = np.asarray([region.scale for region in regions])
    extents_all = np.asarray([
        (region.window.height, region.window.width) for region in regions
    ], dtype=np.int64).reshape(-1, 2)
    dst_tiles = np.empty(len(regions), np.int64)
    for tile in np.unique(src_tiles):
        at = np.flatnonzero(src_tiles == tile)
        _, need = plan_region_flatten(
            angles_all[at], scales_all[at], int(tile), 1 << 30,
            content_extents=extents_all[at],
        )
        dst_tiles[at] = [_dst_tile(int(n), config) for n in need.max(axis=1)]

    # Device calls run in chunks of regions sharing both tiles, each
    # flattened and composited before the next, so the card holds one
    # chunk's tiles at a time.
    groups: Dict[Tuple[int, int], List[int]] = {}
    for pos in range(len(regions)):
        groups.setdefault((int(src_tiles[pos]), int(dst_tiles[pos])),
                          []).append(pos)
    chunks: List[Tuple[int, int, List[int]]] = []
    flat_extents: List[Optional[Tuple[int, int]]] = [None] * len(regions)
    flat_chars: List[List[Polygon]] = [[] for _ in regions]
    quads_pp = getattr(result, 'char_quads', None)

    for (tile, dst_tile), positions in sorted(groups.items()):
        chunk = _flatten_rows(tile, dst_tile)
        for i0 in range(0, len(positions), chunk):
            sub = positions[i0:i0 + chunk]
            chunks.append((tile, dst_tile, sub))
            mats, w_extents = plan_region_flatten(
                angles_all[sub], scales_all[sub], tile, dst_tile,
                content_extents=extents_all[sub],
            )

            # Char polygons through the SAME mats, one einsum per chunk
            # (raw (G, 4, 2) quads when available — no Polygon access).
            groups_of, points, counts_per_pos = [], [], []
            for row, pos in enumerate(sub):
                region = regions[pos]
                origin = np.asarray(
                    [region.window.left, region.window.up], np.float64
                )
                q = (quads_pp[region.page_id]
                     if quads_pp is not None else None)
                if q is not None and len(region.char_idxs):
                    rel = q[region.char_idxs] - origin
                    points.append(rel.reshape(-1, 2))
                    groups_of.extend([row] * (4 * len(region.char_idxs)))
                    counts = [4] * len(region.char_idxs)
                else:
                    counts = []
                    for cidx in region.char_idxs:
                        xy = result.char_polygons[region.page_id][cidx].np_xy
                        points.append(xy - origin)
                        groups_of.extend([row] * len(xy))
                        counts.append(len(xy))
                counts_per_pos.append(counts)
            mapped = region_flatten_point_map(
                mats, np.asarray(groups_of, np.int64),
                np.concatenate(points, axis=0),
            ) if points else np.zeros((0, 2))

            at = 0
            for row, pos in enumerate(sub):
                eh, ew = (int(v) for v in w_extents[row])
                flat_extents[pos] = (eh, ew)
                for count_ in counts_per_pos[row]:
                    flat_chars[pos].append(
                        Polygon.from_np_xy(mapped[at:at + count_])
                    )
                    at += count_

    # ------------------------------------------------------------------
    # Pack: shelf-pack flattened extents onto square canvases.
    # ------------------------------------------------------------------
    s = config.page_size
    inner = config.region_pad
    usable = s - 2 * config.page_pad
    sizes = []
    for pos in range(len(regions)):
        eh, ew = flat_extents[pos]
        sizes.append((min(ew + 2 * inner, usable),
                      min(eh + 2 * inner, usable)))
    placements = pack_rectangles(sizes, usable)

    # Split the one tall shelf stack into page-sized canvases.  Regions
    # sharing a packed y form one shelf; the shelf height is the MAX rect
    # height on that shelf (not the first-seen rect's — the packer places
    # the tallest rect at x=0, which need not be the lowest index), so
    # the next shelf's base never lands inside the previous one.
    page_of: List[int] = [0] * len(regions)
    offset_of: List[Tuple[int, int]] = [(0, 0)] * len(regions)
    shelf_members: Dict[int, List[int]] = {}
    for i in range(len(regions)):
        shelf_members.setdefault(placements[i][1], []).append(i)
    canvas_idx, next_free = 0, 0
    for y in sorted(shelf_members):
        members = shelf_members[y]
        shelf_h = max(sizes[i][1] for i in members)
        # New shelf: does it fit on the current canvas?
        if next_free + shelf_h > usable and next_free > 0:
            canvas_idx += 1
            next_free = 0
        shelf_base = next_free
        next_free = shelf_base + shelf_h
        for i in members:
            page_of[i] = canvas_idx
            offset_of[i] = (placements[i][0], shelf_base)
    num_pages = canvas_idx + 1
    # The reference's page count, padded to a power of two; rows beyond
    # num_pages stay blank background.
    m_pad = 1
    while m_pad < num_pages:
        m_pad *= 2

    background = build_background_image_for_stacking(s, s).mat

    region_boxes: List[List[Box]] = [[] for _ in range(num_pages)]
    page_chars: List[List[Polygon]] = [[] for _ in range(num_pages)]
    box_targets: List[Box] = []
    for pos, region in enumerate(regions):
        x, y = offset_of[pos]
        eh, ew = flat_extents[pos]
        up = y + inner + config.page_pad
        left = x + inner + config.page_pad
        target = Box(up, min(up + eh - 1, s - 1),
                     left, min(left + ew - 1, s - 1))
        box_targets.append(target)
        region_boxes[page_of[pos]].append(target)
        for poly in flat_chars[pos]:
            page_chars[page_of[pos]].append(
                poly.to_shifted_polygon(up, left)
            )

    # ------------------------------------------------------------------
    # Gather, flatten and composite a chunk at a time (rgb + active
    # coverage together; nothing fetches).  Packed boxes never overlap,
    # so the chunks' order changes no pixel.
    # ------------------------------------------------------------------
    out = convert.to_tensor(background, device).expand(
        m_pad, s, s, 3).contiguous()
    active_acc = torch.zeros((m_pad, s, s), dtype=torch.float32,
                             device=device)
    for tile, dst_tile, sub in chunks:
        rows = len(sub)
        sids = np.zeros(rows, np.int32)
        ups = np.zeros(rows, np.int32)
        lefts = np.zeros(rows, np.int32)
        hs = np.ones(rows, np.float32)
        ws = np.ones(rows, np.float32)
        quads = np.zeros((rows, 4, 2), np.float32)
        for row, pos in enumerate(sub):
            # Dilated word polygon, window-relative (the region mask — a
            # raw bbox window would composite ink from neighboring words
            # whose chars carry no labels on this region's copy; the
            # reference masks to the extended region polygon,
            # page_text_region.py:478-558).
            region = regions[pos]
            w = region.window
            xy = region.poly_xy
            if xy.shape[0] == 4:
                rel = xy - np.asarray([w.left, w.up], np.float64)
            else:  # non-quad word outline: fall back to the window bbox
                rel = np.asarray([
                    (0, 0), (w.width - 1.0, 0),
                    (w.width - 1.0, w.height - 1.0), (0, w.height - 1.0),
                ])
            center = rel.mean(axis=0)
            sids[row] = region.page_id
            ups[row] = w.up
            lefts[row] = w.left
            hs[row] = w.height
            ws[row] = w.width
            quads[row] = center + (rel - center) * (1.0 + config.dilate_ratio)

        with measure('region.gather+flatten'):
            stack_dev = gather_region_windows(
                images_dev, active_dev, sids, ups, lefts, hs, ws,
                quads, tile=tile,
            )
            warped_dev, _ = batch_flatten_regions(
                stack_dev, angles_all[sub], scales_all[sub], dst_tile,
                content_extents=extents_all[sub],
            )
            del stack_dev

        with measure('region.composite'):
            tiles_a = (warped_dev[..., 3] > 0.5).to(torch.float32)
            tiles_rgb = torch.clamp(warped_dev[..., :3], 0, 255)
            del warped_dev
            placement_rows = []
            for row, pos in enumerate(sub):
                target = box_targets[pos]
                th = target.down - target.up + 1
                tw = target.right - target.left + 1
                placement_rows.append({
                    'glyph_id': row, 'sample_id': page_of[pos],
                    'up': target.up, 'left': target.left,
                    'dst_h': th, 'dst_w': tw,
                    'src_h': float(th), 'src_w': float(tw),
                    'color': np.zeros(3, np.float32),
                })
            placements_dev = build_placements(placement_rows, bucket=8)
            use_rgbs = np.ones(placements_dev.num_rows, dtype=np.float32)
            out, active_acc = composite_patches_and_alpha(
                out, active_acc, tiles_a, tiles_rgb, use_rgbs,
                placements_dev, out_tile=dst_tile,
            )
            del tiles_a, tiles_rgb
    active = (active_acc > 0.5).to(torch.uint8)

    # ------------------------------------------------------------------
    # Labels: device gaussians + vectorized regression encodings.
    # ------------------------------------------------------------------
    with measure('region.gaussians'):
        gaussians = _char_gaussian_maps(
            page_chars + [[] for _ in range(m_pad - num_pages)], (s, s),
            tile=config.gaussian_tile, device=device,
        )
    with measure('region.regression-host'):
        regression: List[CharRegression] = []
        for polys in page_chars:
            if polys:
                corners = np.stack([p.np_xy[:4] for p in polys])
                centers = corners.mean(axis=1)
                regression.append(
                    char_regression_encodings(corners, centers)
                )
            else:
                empty = np.zeros((0, 4, 2))
                regression.append(char_regression_encodings(
                    empty, np.zeros((0, 2))
                ))

    # ------------------------------------------------------------------
    # Crops (page_text_region_cropping.py windows, device extraction).
    # ------------------------------------------------------------------
    crop_images = crop_gaussians = crop_active = crop_page_ids = None
    num_crops = 0
    if config.num_crops_per_page > 0 and s >= config.crop_size:
        c = config.crop_size
        sids, ups, lefts = [], [], []
        for page_idx in range(num_pages):
            for _ in range(config.num_crops_per_page):
                if not region_boxes[page_idx]:
                    continue
                anchor = region_boxes[page_idx][
                    int(rng.integers(0, len(region_boxes[page_idx])))
                ]
                cy = (anchor.up + anchor.down) // 2
                cx = (anchor.left + anchor.right) // 2
                up = int(np.clip(
                    cy - c // 2 + int(rng.integers(-c // 4, c // 4 + 1)),
                    0, s - c,
                ))
                left = int(np.clip(
                    cx - c // 2 + int(rng.integers(-c // 4, c // 4 + 1)),
                    0, s - c,
                ))
                sids.append(page_idx)
                ups.append(up)
                lefts.append(left)
        if sids:
            num_crops = len(sids)
            crop_images, labs, crop_active = _extract_crops_program(
                out, gaussians[..., None], active, sids, ups, lefts, size=c,
            )
            crop_gaussians = labs[..., 0]
            crop_page_ids = np.asarray(sids, np.int32)

    profiling.count('synth.region_pages', num_pages)
    profiling.count('synth.region_crops', num_crops)
    if not keep_on_device:
        out = out.cpu().numpy()[:num_pages]
        active = active.cpu().numpy()[:num_pages]
        gaussians = gaussians.cpu().numpy()[:num_pages]
        if crop_images is not None:
            crop_images = crop_images.cpu().numpy()
            crop_gaussians = crop_gaussians.cpu().numpy()
            crop_active = crop_active.cpu().numpy()

    return RegionBatchResult(
        images=out,
        active_masks=active,
        gaussian_maps=gaussians,
        region_boxes=region_boxes,
        char_polygons=page_chars,
        regression=regression,
        crop_images=crop_images,
        crop_gaussians=crop_gaussians,
        crop_active=crop_active,
        crop_page_ids=crop_page_ids,
        num_pages=num_pages,
        num_crops=num_crops,
    )
