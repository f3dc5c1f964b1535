"""The batched page-synthesis program on the device: assemble ->
photometric stage -> geometric warp -> finish -> crops.

Port of vkit_tpu/synth/device.py: ``_composite_overlays``,
``_extract_crops_program``, ``_finish_program_const``, ``_finish_program``,
``synthesize_page_batch`` and ``synthesize_stream``.  Host work (page prep,
plan sampling, active masks, polygon co-transform, crop-window sampling)
is the reference's own code, called in the same order with the same rng,
so plans and crop windows match the JAX run draw for draw.

The photometric stage is on by default, as in the reference: its policy
draws come from the same ``rng`` before the geometric plans do.  Not ported
yet (raise NotImplementedError): char gaussian maps (ROADMAP.md slice 4) and
the text-region stream (slice 5).
"""
import contextlib
import queue
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from numpy.random import Generator as RandomGenerator

from vkit_tpu.element import Box, Polygon
from vkit_tpu.engine.font.atlas import global_atlas_pack
from vkit_tpu.mechanism.batched_random import sample_geometric_plans
from vkit_tpu.mechanism.distortion.warp_plan import (
    nop_plan,
    plan_content_box,
    rescale_plan_to,
    warp_active_mask,
)
from vkit_tpu.synth.device import (
    _OVERLAY_TILE_LADDER,
    CropConfig,
    SynthBatchResult,
    _affine_stretches,
    _sample_crop_windows,
    _split_oversized_overlay,
)
from vkit_tpu.synth.prep import CHAR_HEIGHT, TEXT_LINE_HEIGHT, HostPage

from .. import convert
from ..engine.font.atlas import pack_placements
from ..mechanism.batched import batched_plan_warp
from ..mechanism.batched_random import batch_random_photometric_distort
from ..ops.glyph import build_placements, composite_glyphs, composite_patches

__all__ = ['CropConfig', 'SynthBatchResult', 'synthesize_page_batch',
           'synthesize_stream']


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
    """``timer.measure(name)``, closed by a device synchronize; a span that
    does nothing without a timer."""
    if timer is None:
        return lambda name: contextlib.nullcontext()

    @contextlib.contextmanager
    def measure(name):
        with timer.measure(name):
            yield
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

    return measure


def _check_ported(emit_char_gaussians, region_config):
    if emit_char_gaussians:
        raise NotImplementedError(
            'char gaussian maps are not ported yet (ROADMAP.md slice 4)'
        )
    if region_config is not None:
        raise NotImplementedError(
            'the text-region stream is not ported yet (ROADMAP.md slice 5)'
        )


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
    compiled shapes).

    ``timer``: an object with a ``measure(name)`` context manager, such as
    vkit_tpu's ``StepTimer``.  With one, each stage is a span that ends with
    a device synchronize, so it holds the stage's device time; the spans
    serialize host and device work, so leave it None outside profiling."""
    _check_ported(emit_char_gaussians, region_config)
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

    if not keep_on_device:
        with measure('fetch'):
            images, label_stack, active_u8 = (
                t.cpu().numpy() for t in (images, label_stack, active_u8)
            )
            if crop_images is not None:
                crop_images, crop_labels, crop_active = (
                    t.cpu().numpy()
                    for t in (crop_images, crop_labels, crop_active)
                )

    return SynthBatchResult(
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
        num_crops=num_crops,
        char_quads=char_quads,
    )


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
    Per-batch child seeds are drawn from ``rng`` up front, in order."""
    _check_ported(emit_char_gaussians, region_config)
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
                prep_queue.put(planner.prepare_batch(batch_size, batch_rng))
        except Exception as exc:  # noqa: BLE001 - relayed to the consumer
            prep_queue.put(exc)
        else:
            prep_queue.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        for idx in range(num_batches + 1):
            pages = prep_queue.get()
            if pages is None:
                break
            if isinstance(pages, Exception):
                raise pages
            yield synthesize_page_batch(
                pages, level=level, rng=level_rngs[idx],
                out_shape=out_shape, crop_config=crop_config,
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
