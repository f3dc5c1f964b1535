"""The batched page-synthesis program on the device: assemble ->
photometric stage -> geometric warp -> finish -> char gaussians -> crops ->
text-region stream.

Port of vkit_tpu/synth/device.py: ``_composite_overlays``,
``_char_gaussian_maps``, ``_extract_crops_program``,
``_finish_program_const``, ``_finish_program``, ``synthesize_page_batch``
and ``synthesize_stream``.  Host work (page prep,
plan sampling, active masks, polygon co-transform, crop-window sampling)
is the reference's own code (``_sample_crop_windows``,
``_split_oversized_overlay``, ``_affine_stretches``, the result types),
called in the same order with the same rng, so plans and crop windows match
the JAX run draw for draw.

The photometric stage is on by default, as in the reference: its policy
draws come from the same ``rng`` before the geometric plans do.  Both
options of the reference are here: ``emit_char_gaussians`` (per-char
gaussian maps from the post-warp char quads) and ``region_config`` (the
adaptive-scaling text-region stream of synth/region.py, which draws its
crop anchors from ``rng`` after the page crop windows, as the reference
does).  Which kernel runs where: the page warp launches
``row_shift_window_slab`` (affine plans), ``row_shift`` (affine plans whose
span fails the 2048-lane window) or ``banded_line_resample`` (smooth
fields); the region flatten launches ``row_shift_window_slab`` twice per
flatten chunk.
"""
import contextlib
import queue
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from numpy.random import Generator as RandomGenerator

from .. import convert
from ..element import Box, Polygon
from ..engine.font.atlas import global_atlas_pack, pack_placements
from ..mechanism.batched import batched_plan_warp
from ..mechanism.batched_random import (
    batch_random_photometric_distort,
    sample_geometric_plans,
)
from ..mechanism.distortion.warp_plan import (
    nop_plan,
    plan_content_box,
    rescale_plan_to,
    warp_active_mask,
)
from ..ops.glyph import (
    GlyphPlacements,
    accumulate_glyph_alpha,
    build_placements,
    composite_glyphs,
    composite_patches,
)
from ..ops.region import batch_char_heatmaps
from ..utility import profiling
from .prep import CHAR_HEIGHT, TEXT_LINE_HEIGHT, HostPage

__all__ = ['CropConfig', 'SynthBatchResult', 'synthesize_page_batch',
           'synthesize_stream']


# ---------------------------------------------------------------------------
# Host half (numpy): result types, overlay splitting, crop windows.
# ---------------------------------------------------------------------------


_OVERLAY_TILE_LADDER = (64, 128, 192, 256, 384, 512)


def _split_oversized_overlay(sid, e, tile):
    """Chop a stamp larger than the tile ladder into <= tile sub-entries
    (adjacent, non-overlapping, so z-order within the stamp is moot).
    The reference assembler composites stamps of ANY size
    (vkit/pipeline/text_detection/page_assembler.py:154-274) — content
    must never be size-dropped."""
    import attr

    h, w = e.alpha.shape
    out = []
    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            r1, c1 = min(r0 + tile, h), min(c0 + tile, w)
            out.append((sid, attr.evolve(
                e,
                alpha=e.alpha[r0:r1, c0:c1],
                rgb=None if e.rgb is None else e.rgb[r0:r1, c0:c1],
                up=e.up + r0,
                left=e.left + c0,
            )))
    return out


class SynthBatchResult(NamedTuple):
    images: np.ndarray          # (N, out_h, out_w, 3) uint8
    label_stack: np.ndarray     # (N, out_h, out_w, 4) float32 (see prep.py)
    active_masks: np.ndarray    # (N, out_h, out_w) uint8
    content_boxes: Sequence[Box]          # per-sample active bounding boxes
    word_polygons: Sequence[List[Polygon]]   # co-transformed, out coords
    char_polygons: Sequence[List[Polygon]]
    # Device-extracted training crops (page_cropping.py on device);
    # empty arrays when cropping is disabled.
    crop_images: Optional[np.ndarray] = None    # (M, S, S, 3) uint8
    crop_labels: Optional[np.ndarray] = None    # (M, S, S, 4) float32
    crop_active: Optional[np.ndarray] = None    # (M, S, S) uint8
    crop_page_ids: Optional[np.ndarray] = None  # (M,) int32
    crop_windows: Optional[np.ndarray] = None   # (M, 2) int32 (up, left)
    # Real crop count: with keep_on_device the crop tensors stay PADDED
    # to a power of two on device (static compiled shapes) and rows
    # beyond num_crops are duplicates of row 0.
    num_crops: int = 0
    # Per-char gaussian heatmaps (char_heatmap engine semantics, rendered
    # ON DEVICE from the post-warp char quads); None unless requested.
    char_gaussian_maps: Optional[np.ndarray] = None  # (N, out_h, out_w) f32
    # Raw co-transformed char quads, (G, 4, 2) float64 per page — the
    # same geometry as char_polygons without the per-object overhead;
    # the region stream's hot host loops consume these.  None per page
    # only if a char polygon were not a quad (prep always emits quads).
    char_quads: Optional[Sequence[Optional[np.ndarray]]] = None
    # The adaptive-scaling output family (synth/region.py): stacked
    # region pages + char regression labels + region crops; None unless
    # a RegionStreamConfig was passed.
    text_regions: Optional[object] = None  # RegionBatchResult


def _char_gaussian_maps(char_polygons, out_shape, tile: int = 64,
                        device='cuda'):
    """Analytic gaussian bumps through each post-warp char quad
    (ops/region.batch_char_heatmaps) max-accumulated onto the page canvas
    (ops/glyph.accumulate_glyph_alpha): an (N, out_h, out_w) float32 tensor
    on ``device``.  The reference warps a sampled bump per char on host
    (char_heatmap/default.py); overlap neutralization stays with the host
    engine.  Chars whose box is under 2 px or over ``tile`` are left out,
    as in the reference; the row tables are built per page, not per char."""
    device = convert.resolve_device(device)
    n = len(char_polygons)
    quads, sample_ids, ups, lefts, hs, ws = [], [], [], [], [], []
    for sid, polys in enumerate(char_polygons):
        if not polys:
            continue
        xy = np.stack([p.np_xy for p in polys]).astype(np.float64)
        up = np.floor(xy[..., 1].min(axis=1))
        left = np.floor(xy[..., 0].min(axis=1))
        h = xy[..., 1].max(axis=1) - up + 1
        w = xy[..., 0].max(axis=1) - left + 1
        keep = ~((h < 2) | (w < 2) | (h > tile) | (w > tile))
        quads.append((xy - np.stack([left, up], axis=1)[:, None, :])[keep])
        sample_ids.append(np.full(int(keep.sum()), sid))
        ups.append(up[keep])
        lefts.append(left[keep])
        hs.append(np.ceil(h[keep]))
        ws.append(np.ceil(w[keep]))
    canvas = torch.zeros((n,) + tuple(out_shape), dtype=torch.float32,
                         device=device)
    count = sum(len(q) for q in quads)
    if not count:
        return canvas
    tiles = batch_char_heatmaps(np.concatenate(quads), tile=tile,
                                device=device)

    def ints(parts):
        return np.concatenate(parts).astype(np.int32)

    dst_hs, dst_ws = ints(hs), ints(ws)
    placements = GlyphPlacements(
        glyph_ids=np.arange(count, dtype=np.int32),
        sample_ids=ints(sample_ids),
        ups=ints(ups),
        lefts=ints(lefts),
        dst_hs=dst_hs,
        dst_ws=dst_ws,
        src_hs=dst_hs.astype(np.float32),
        src_ws=dst_ws.astype(np.float32),
        colors=np.zeros((count, 3), np.float32),
        valids=np.ones(count, np.float32),
    )
    return accumulate_glyph_alpha(canvas, tiles, placements, out_tile=tile)


class CropConfig(NamedTuple):
    """Device cropping knobs (page_cropping.py semantics: N random crops
    + filters; extraction runs as one device program over the warped
    stack, no full-page readback needed to sample windows)."""
    core_size: int
    num_per_page: int = 2
    text_ratio_min: float = 0.025
    active_ratio_min: float = 0.4
    retries: int = 10


def _sample_crop_windows(
    out_shape: Tuple[int, int],
    content_boxes: Sequence[Box],
    word_polygons: Sequence[List[Polygon]],
    crop: 'CropConfig',
    rng: RandomGenerator,
):
    """Per-page crop windows from ANALYTIC info only (content boxes +
    co-transformed word polygons): the text/active filters of
    page_cropping.py:87 evaluated on polygon bounding boxes instead of
    label rasters, so no device->host readback gates the sampling.

    ``active_ratio_min`` is enforced on the content-box BBOX — an upper
    bound on true raster coverage, so for strongly rotated/warped pages
    a crop the reference's raster filter would reject (true active ratio
    below the threshold) can still be emitted.  The text_ratio filter
    (word-polygon bboxes, tight) dominates in practice."""
    h, w = out_shape
    s = crop.core_size
    sample_ids: List[int] = []
    ups: List[int] = []
    lefts: List[int] = []
    for idx, (cbox, words) in enumerate(zip(content_boxes, word_polygons)):
        if h < s or w < s:
            continue
        boxes = []
        for poly in words:
            xy = poly.np_xy
            boxes.append((xy[:, 1].min(), xy[:, 1].max(),
                          xy[:, 0].min(), xy[:, 0].max()))
        boxes_np = np.asarray(boxes, dtype=np.float64) if boxes else None

        def window_ok(up: int, left: int) -> bool:
            if boxes_np is not None:
                iu = np.maximum(boxes_np[:, 0], up)
                id_ = np.minimum(boxes_np[:, 1], up + s - 1)
                il = np.maximum(boxes_np[:, 2], left)
                ir = np.minimum(boxes_np[:, 3], left + s - 1)
                area = (np.maximum(id_ - iu + 1, 0)
                        * np.maximum(ir - il + 1, 0)).sum()
                if area / (s * s) < crop.text_ratio_min:
                    return False
            elif crop.text_ratio_min > 0:
                return False
            au = max(cbox.up, up)
            ad = min(cbox.down, up + s - 1)
            al = max(cbox.left, left)
            ar = min(cbox.right, left + s - 1)
            active = max(ad - au + 1, 0) * max(ar - al + 1, 0)
            return active / (s * s) >= crop.active_ratio_min

        accepted = 0
        for _ in range(crop.num_per_page):
            placed = False
            for _ in range(crop.retries):
                up = int(rng.integers(0, h - s + 1))
                left = int(rng.integers(0, w - s + 1))
                if window_ok(up, left):
                    placed = True
                    break
            if not placed:
                # Centered-on-content fallback (the reference's center
                # crop), clamped to the canvas.
                up = int(np.clip((cbox.up + cbox.down) // 2 - s // 2,
                                 0, h - s))
                left = int(np.clip((cbox.left + cbox.right) // 2 - s // 2,
                                   0, w - s))
                if not window_ok(up, left):
                    continue
            sample_ids.append(idx)
            ups.append(up)
            lefts.append(left)
            accepted += 1
    return (np.asarray(sample_ids, dtype=np.int32),
            np.asarray(ups, dtype=np.int32),
            np.asarray(lefts, dtype=np.int32))


def _affine_stretches(plans) -> np.ndarray:
    """Per-sample constant vertical stretch of affine/nop plans: the
    inverse of how many source pixels one dst row step covers."""
    out = np.ones(len(plans), dtype=np.float32)
    for i, plan in enumerate(plans):
        if plan.matrix is None:
            continue
        mat3 = np.eye(3, dtype=np.float64)
        m = np.asarray(plan.matrix, dtype=np.float64)
        mat3[:m.shape[0]] = m
        inv = np.linalg.inv(mat3)
        step = float(np.hypot(inv[0, 1], inv[1, 1]))
        out[i] = 1.0 / max(step, 1e-3)
    return np.clip(out, 0.05, 20.0)


# ---------------------------------------------------------------------------
# Device program.
# ---------------------------------------------------------------------------


def _composite_overlays(assembled, overlay):
    """Blend the above-text page layers (symbols, seal stamps) in z-order.
    ``overlay``: [(sample_id, OverlayEntry)].  Stamps beyond the tile
    ladder split into ladder-sized sub-tiles; nothing is dropped."""
    tile_max = _OVERLAY_TILE_LADDER[-1]
    flat = []
    for sid, e in overlay:
        if max(e.alpha.shape) <= tile_max:
            flat.append((sid, e))
        else:
            flat.extend(_split_oversized_overlay(sid, e, tile_max))
    overlay = flat
    if not overlay:
        return assembled
    max_dim = max(max(e.alpha.shape) for _, e in overlay)
    tile = next(t for t in _OVERLAY_TILE_LADDER if t >= max_dim)
    count = len(overlay)
    bucket = 8
    while bucket < count:
        bucket *= 2

    tiles_a = np.zeros((bucket, tile, tile), dtype=np.float32)
    tiles_rgb = np.zeros((bucket, tile, tile, 3), dtype=np.float32)
    rows = []
    use_rgbs = np.zeros(bucket, dtype=np.float32)
    for i, (sid, e) in enumerate(overlay):
        h, w = e.alpha.shape
        tiles_a[i, :h, :w] = e.alpha
        if e.rgb is not None:
            tiles_rgb[i, :h, :w] = e.rgb
            use_rgbs[i] = 1.0
        rows.append({
            'glyph_id': i, 'sample_id': sid, 'up': e.up, 'left': e.left,
            'dst_h': h, 'dst_w': w, 'src_h': float(h), 'src_w': float(w),
            'color': np.asarray(e.color, dtype=np.float32),
        })
    placements = build_placements(rows, bucket=bucket)
    device = assembled.device
    return composite_patches(
        assembled,
        convert.to_tensor(tiles_a, device),
        convert.to_tensor(tiles_rgb, device),
        use_rgbs, placements, out_tile=tile,
    )


def _extract_crops_program(images, labels, active, sample_ids, ups, lefts,
                           size: int):
    """Cut each (sample, up, left) window out of the warped page stack.
    Starts clamp into the page like ``lax.dynamic_slice``."""
    n, h, w = active.shape
    imgs, labs, acts = [], [], []
    for sid, up, left in zip(sample_ids, ups, lefts):
        sid = min(max(int(sid), 0), n - 1)
        up = min(max(int(up), 0), h - size)
        left = min(max(int(left), 0), w - size)
        window = (sid, slice(up, up + size), slice(left, left + size))
        imgs.append(images[window])
        labs.append(labels[window])
        acts.append(active[window])
    return torch.stack(imgs), torch.stack(labs), torch.stack(acts)


def _gate_and_split(x, active):
    """Gate every channel by the active mask; split image and labels.
    ``x`` is updated in place."""
    on = active > 0.5
    x.mul_(on.to(torch.float32)[..., None])
    images = torch.clamp(torch.round(x[..., :3]), 0, 255).to(torch.uint8)
    return images, x[..., 3:], on.to(torch.uint8)


def _finish_program_const(stack, stretches, active):
    """Finish for all-affine batches: the local vertical stretch is a
    per-sample constant derived from the matrices.  ``stack`` is scaled in
    place when it is already float32 (the reference donated it)."""
    x = stack.to(torch.float32)
    stretch = stretches[:, None, None]
    x[..., 3 + TEXT_LINE_HEIGHT].mul_(stretch)
    x[..., 3 + CHAR_HEIGHT].mul_(stretch)
    return _gate_and_split(x, active)


def _finish_program(stack, map_ys, map_xs, active):
    """Height-channel correction by the warp's local vertical stretch
    ||d(src)/d(dst_y)||^-1 of the backward maps, then the active gate.
    ``stack`` is updated in place when it is already float32."""
    x = stack.to(torch.float32)
    dmy = torch.diff(map_ys, dim=1, append=map_ys[:, -1:, :])
    dmx = torch.diff(map_xs, dim=1, append=map_xs[:, -1:, :])
    step = torch.sqrt(dmy * dmy + dmx * dmx)
    stretch = torch.clamp(1.0 / torch.clamp(step, min=1e-3), 0.05, 20.0)
    x[..., 3 + TEXT_LINE_HEIGHT].mul_(stretch)
    x[..., 3 + CHAR_HEIGHT].mul_(stretch)
    return _gate_and_split(x, active)


def _co_transform(plans, pages):
    """Host: analytic polygon co-transform (one map_points per page) and
    content boxes from the plan geometry."""
    word_polygons: List[List[Polygon]] = []
    char_polygons: List[List[Polygon]] = []
    char_quads: List[Optional[np.ndarray]] = []
    content_boxes: List[Box] = []
    for plan, page in zip(plans, pages):
        w_pts = [p.to_np_array() for p in page.word_polygons]
        c_pts = [p.to_np_array() for p in page.char_polygons]
        counts = [len(a) for a in w_pts] + [len(a) for a in c_pts]
        flat = (np.concatenate(w_pts + c_pts, axis=0)
                if (w_pts or c_pts) else np.zeros((0, 2)))
        mapped = plan.map_points(flat)
        polys, at = [], 0
        for cnt in counts:
            polys.append(Polygon.from_np_array(mapped[at:at + cnt]))
            at += cnt
        word_polygons.append(polys[:len(w_pts)])
        char_polygons.append(polys[len(w_pts):])
        if all(len(a) == 4 for a in c_pts):
            quads = (mapped[-4 * len(c_pts):].reshape(-1, 4, 2)
                     if c_pts else np.zeros((0, 4, 2)))
        else:
            quads = None
        char_quads.append(quads)
        content_boxes.append(plan_content_box(plan))
    return word_polygons, char_polygons, char_quads, content_boxes


def _spans(timer, device):
    """A stage's spans: the program span ``synth.<name>``
    (utility/profiling.py: free without an active recording, and it waits
    for nothing), and with a timer also ``timer.measure(name)``, closed by
    a device synchronize."""
    if timer is None:
        return lambda name: profiling.span('synth.' + name)

    @contextlib.contextmanager
    def measure(name):
        with profiling.span('synth.' + name), timer.measure(name):
            yield
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

    return measure


def synthesize_page_batch(
    pages: Sequence[HostPage],
    level: int,
    rng: RandomGenerator,
    out_shape: Optional[Tuple[int, int]] = None,
    enable_photometric: bool = True,
    enable_geometric: bool = True,
    placement_bucket: int = 1024,
    crop_config: Optional[CropConfig] = None,
    emit_char_gaussians: bool = False,
    region_config=None,
    keep_on_device: bool = False,
    device='cuda',
    timer=None,
) -> SynthBatchResult:
    """Run the synthesis program over N host-prepped pages on ``device``.

    ``out_shape`` (default: the page shape) is the output canvas; every
    randomized geometric draw folds its resize into the warp plan.  With
    ``keep_on_device`` the raster outputs stay tensors on ``device``;
    otherwise they are fetched to numpy.  Crop tensors hold exactly
    ``num_crops`` rows (the reference pads them to a power of two for its
    compiled shapes).  ``emit_char_gaussians`` adds per-char gaussian maps;
    a ``region_config`` (synth.region.RegionStreamConfig) adds the stacked
    text-region pages as ``text_regions``.

    ``timer``: an object with a ``measure(name)`` context manager, such as
    vkit_tpu's ``StepTimer``.  With one, each stage is a span that ends with
    a device synchronize, so it holds the stage's device time; the spans
    serialize host and device work, so leave it None outside profiling.

    Each stage is also a program span ``synth.<stage>`` of the active
    recording (utility/profiling.py), which synchronizes nothing:
    ``synth.assemble``, ``.photometric``, ``.plan-host``, ``.warp``,
    ``.active-host``, ``.finish``, ``.polygons-host``, ``.char-gaussians``,
    ``.crops``, ``.region`` (its parts ``synth.region.*``) and ``.fetch``;
    the counters ``synth.pages`` and ``synth.crops`` add the batch's pages
    and page crops (``synth.region_pages``, ``.region_crops`` and
    ``.regions`` those of the text-region stream)."""
    device = convert.resolve_device(device)
    n = len(pages)
    if n == 0:
        raise ValueError('empty page batch')
    height, width = pages[0].background.shape[:2]
    if any(p.background.shape[:2] != (height, width) for p in pages):
        raise ValueError('pages of one batch must share their shape')

    measure = _spans(timer, device)

    # 1. Assemble: glyphs, then the above-text layers (symbols, seals).
    with measure('assemble'):
        assembled = convert.to_tensor(
            np.stack([p.background for p in pages]), device
        )
        entries = [
            (layout, anchor, sample_id, color, atlas)
            for sample_id, page in enumerate(pages)
            for layout, anchor, color, atlas in page.line_entries
        ]
        if entries:
            placements, tiles, out_tile = pack_placements(
                entries, global_atlas_pack(), bucket=placement_bucket,
                device=device,
            )
            assembled = composite_glyphs(assembled, tiles, placements,
                                         out_tile=out_tile)
        overlay = [
            (sample_id, entry)
            for sample_id, page in enumerate(pages)
            for entry in page.overlay_entries
        ]
        if overlay:
            assembled = _composite_overlays(assembled, overlay)

    # 2. Photometric stage: policy-sampled rounds on the device.
    if enable_photometric:
        with measure('photometric'):
            assembled = batch_random_photometric_distort(assembled, level,
                                                         rng)

    # 3. Geometric stage: one warp moves image + labels together, the
    # final resize folded into each plan.
    out_shape = tuple(out_shape or (height, width))
    with measure('plan-host'):
        if enable_geometric:
            raw_plans = sample_geometric_plans(n, (height, width), level,
                                               rng)
        else:
            raw_plans = [nop_plan((height, width)) for _ in range(n)]
        plans = [rescale_plan_to(p, out_shape) for p in raw_plans]

    with measure('warp'):
        labels = convert.to_tensor(
            np.stack([p.label_stack for p in pages]), device, torch.float32
        )
        stack = torch.cat([assembled.to(torch.float32), labels], dim=-1)
        del labels
        warped, _, _, maps = batched_plan_warp(
            plans, stack, return_maps=True, mode='auto'
        )
        del stack
    if tuple(warped.shape[1:3]) != out_shape:
        raise RuntimeError(f'warp canvas {tuple(warped.shape[1:3])} != '
                           f'{out_shape}')

    with measure('active-host'):
        active = np.zeros((n,) + out_shape, dtype=np.uint8)
        for idx, plan in enumerate(plans):
            active[idx] = warp_active_mask(plan).mat
        active = convert.to_tensor(active, device)

    # 4. Finish: height correction, active gate, uint8 images.
    with measure('finish'):
        if maps is None:
            images, label_stack, active_u8 = _finish_program_const(
                warped,
                convert.to_tensor(_affine_stretches(plans), device),
                active,
            )
        else:
            images, label_stack, active_u8 = _finish_program(
                warped, maps[0], maps[1], active
            )
        del warped, maps

    with measure('polygons-host'):
        word_polygons, char_polygons, char_quads, content_boxes = \
            _co_transform(plans, pages)

    gaussians = None
    if emit_char_gaussians:
        with measure('char-gaussians'):
            gaussians = _char_gaussian_maps(char_polygons, out_shape,
                                            device=device)

    # 5. Crops: windows from analytic info, cut on the device.
    crop_images = crop_labels = crop_active = crop_page_ids = None
    crop_windows = None
    num_crops = 0
    if crop_config is not None:
        with measure('crops'):
            sids, c_ups, c_lefts = _sample_crop_windows(
                out_shape, content_boxes, word_polygons, crop_config, rng
            )
            if len(sids):
                num_crops = len(sids)
                crop_images, crop_labels, crop_active = \
                    _extract_crops_program(
                        images, label_stack, active_u8, sids, c_ups,
                        c_lefts, size=crop_config.core_size,
                    )
                crop_page_ids = sids
                crop_windows = np.stack([c_ups, c_lefts], axis=1)

    profiling.count('synth.pages', n)
    profiling.count('synth.crops', num_crops)
    result = SynthBatchResult(
        images=images,
        label_stack=label_stack,
        active_masks=active_u8,
        content_boxes=content_boxes,
        word_polygons=word_polygons,
        char_polygons=char_polygons,
        crop_images=crop_images,
        crop_labels=crop_labels,
        crop_active=crop_active,
        crop_page_ids=crop_page_ids,
        crop_windows=crop_windows,
        char_gaussian_maps=gaussians,
        num_crops=num_crops,
        char_quads=char_quads,
    )

    # 6. The text-region stream, on the pages while they are on the device.
    if region_config is not None:
        from .region import stack_text_regions

        with measure('region'):
            result = result._replace(text_regions=stack_text_regions(
                result, region_config, rng, keep_on_device=keep_on_device,
                timer=timer, device=device,
            ))

    if not keep_on_device:
        with measure('fetch'):
            result = result._replace(**{
                name: getattr(result, name).cpu().numpy()
                for name in ('images', 'label_stack', 'active_masks',
                             'crop_images', 'crop_labels', 'crop_active',
                             'char_gaussian_maps')
                if getattr(result, name) is not None
            })
    return result


def synthesize_stream(
    planner,
    batch_size: int,
    level: int,
    rng: RandomGenerator,
    num_batches: int,
    out_shape: Optional[Tuple[int, int]] = None,
    prefetch: int = 2,
    crop_config: Optional[CropConfig] = None,
    emit_char_gaussians: bool = False,
    region_config=None,
    keep_on_device: bool = False,
    device='cuda',
):
    """Generator of SynthBatchResults with host prep overlapped against
    device work: a background thread keeps up to ``prefetch`` prepared
    page batches queued while the device program drains the previous one.
    Per-batch child seeds are drawn from ``rng`` up front, in order.
    Program spans: ``synth.prep`` around each batch's prep on that thread,
    ``synth.prep_wait`` around the wait for it here."""
    device = convert.resolve_device(device)
    prep_queue: 'queue.Queue' = queue.Queue(maxsize=max(prefetch, 1))
    seeds = [int(rng.integers(0, 2**63 - 1)) for _ in range(num_batches)]
    level_rngs = [np.random.default_rng(seed) for seed in seeds]
    stop = threading.Event()

    def producer():
        # A producer failure surfaces in the consumer instead of leaving
        # it blocked on the queue.
        try:
            for batch_rng in level_rngs:
                if stop.is_set():
                    return
                with profiling.span('synth.prep'):
                    pages = planner.prepare_batch(batch_size, batch_rng)
                prep_queue.put(pages)
        except Exception as exc:  # noqa: BLE001 - relayed to the consumer
            prep_queue.put(exc)
        else:
            prep_queue.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        for idx in range(num_batches + 1):
            with profiling.span('synth.prep_wait'):
                pages = prep_queue.get()
            if pages is None:
                break
            if isinstance(pages, Exception):
                raise pages
            yield synthesize_page_batch(
                pages, level=level, rng=level_rngs[idx],
                out_shape=out_shape, crop_config=crop_config,
                emit_char_gaussians=emit_char_gaussians,
                region_config=region_config,
                keep_on_device=keep_on_device, device=device,
            )
    finally:
        stop.set()
        # Unblock a producer waiting on a full queue, then join it.
        while thread.is_alive():
            try:
                prep_queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.1)
