"""Traffic generator: vkit's page-synthesis product, one
``synthesize_stream`` over the run in a closed loop (bench.py's config 6).

A background thread of the stream prepares up to ``prefetch`` page batches
on the host while the card runs the batch before; the consumer takes one
batch at a time and forces it complete by fetching what a trainer's input
pipeline takes: the page crops and their labels, the region crops and
their gaussian maps (and a sparse slice of every page and stacked region
page).  A batch is ready when that fetch returns; the next one is asked
for then.

Every run prepares the same pages: the stream's batches cycle through a
pool of ``pool_batches`` batch seeds, the first batches of a stream drawn
from ``pool_seed`` (both in the traffic file), so that the window, which
holds at least one whole cycle, does the same work in every run and its
rate, gap and memory peak vary with the card and its host alone.  (With
every batch drawn from the seed, six runs on an H100 spread the rate by
20% and the gap by 17%.)  The seed picks the checked batch, one of the
pool's: the stream gives it first, as the one warm-up batch, then cycles
the pool from its start.

The check: the checked batch runs with hooks on the program's functions
that keep its prepared pages, the assembled pages, the geometric stage's
input, plans and output, the pages' char polygons and a few region rows
of each flatten call on the host; after the window the plain reference
(``synth_reference.py``) reads them:
- ``assemble_pct``: the percent of the assembled pages' pixels that
  differ from the pages assembled from the prepared pages by their
  definition (the photometric stage and finish are not checked);
- ``warp_lsb``: every page's warp against the exact bilinear remap of the
  stage's own input through the page's plan (covered pixels, eroded as
  the distort cells erode them);
- ``crop_px``: pixels of the page crops that differ from the finished
  pages at the crops' windows (none is right);
- ``flatten_lsb``: the sampled region rows against the flatten's two-pass
  definition in float64;
- ``points_px``: the co-transformed char polygons against the plan's map.
"""
import shutil
import sys
import tempfile
import time

import numpy as np

from cardbench import synth_assets
from cardbench.harness import CACHE, free_device, host_copy as host

# Batches the stream may take: far more than set-up and a window.
NUM_BATCHES = 10_000
# Region rows of each flatten call that the check keeps.
FLATTEN_ROWS = 2
# Channels of the geometric stage's input that hold 0-1 label planes (RGB
# first, then the text-line mask and height, the char mask and height).
PLANES = (3, 5)


class Capture:
    """While entered, the program's ``synthesize_page_batch``,
    ``batch_random_photometric_distort``, ``batched_plan_warp`` (as the
    synth module calls them) and ``batch_flatten_regions`` keep what the
    check reads, on the host."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed, 5])
        self.pages = None
        self.host_pages = None
        self.assembled = None
        self.warp = None
        self.flatten = []
        self._undo = []

    def __enter__(self):
        from vkit_tpu_torch.ops import region
        from vkit_tpu_torch.synth import device

        def page_batch(pages, *args, _fn=device.synthesize_page_batch,
                       **kwargs):
            if self.pages is None:
                self.host_pages = list(pages)
                self.pages = [
                    [p.to_np_array().astype(np.float64)
                     for p in page.char_polygons] for page in pages]
            return _fn(pages, *args, **kwargs)

        def photometric(assembled, *args,
                        _fn=device.batch_random_photometric_distort,
                        **kwargs):
            if self.assembled is None:
                self.assembled = host(assembled)
            return _fn(assembled, *args, **kwargs)

        def plan_warp(plans, stack, *args, _fn=device.batched_plan_warp,
                      **kwargs):
            out = _fn(plans, stack, *args, **kwargs)
            if self.warp is None:
                self.warp = (list(plans), host(stack), host(out[0]))
            return out

        def flatten(patches, angles, scales, dst_tile, *args,
                    _fn=region.batch_flatten_regions, **kwargs):
            out = _fn(patches, angles, scales, dst_tile, *args, **kwargs)
            rows = np.sort(self.rng.choice(
                len(angles), min(FLATTEN_ROWS, len(angles)),
                replace=False))
            extents = kwargs.get('content_extents')
            for r in rows:
                self.flatten.append(dict(
                    patch=host(patches[int(r)]), out=host(out[0][int(r)]),
                    angle=float(angles[r]), scale=float(scales[r]),
                    extent=(tuple(int(v) for v in extents[r])
                            if extents is not None
                            else (patches.shape[1], patches.shape[2])),
                    out_extent=tuple(int(v) for v in out[1][r])))
            return out

        for module, name, value in ((device, 'synthesize_page_batch',
                                     page_batch),
                                    (device,
                                     'batch_random_photometric_distort',
                                     photometric),
                                    (device, 'batched_plan_warp', plan_warp),
                                    (region, 'batch_flatten_regions',
                                     flatten)):
            self._undo.append((module, name, getattr(module, name)))
            setattr(module, name, value)
        return self

    def __exit__(self, *exc):
        for module, name, value in reversed(self._undo):
            setattr(module, name, value)
        self._undo.clear()
        return False


def keep_result(result):
    """The checked batch's finished pages, crops and mapped char polygons
    on the host."""
    n = result.num_crops
    crops = None
    if n:
        crops = dict(
            pages=[host(result.images), host(result.label_stack),
                   host(result.active_masks)],
            crops=[host(result.crop_images[:n]),
                   host(result.crop_labels[:n]),
                   host(result.crop_active[:n])],
            page_ids=np.asarray(result.crop_page_ids[:n]),
            windows=np.asarray(result.crop_windows[:n]))
    points = [[p.np_xy.astype(np.float64) for p in polys]
              for polys in result.char_polygons]
    return dict(crops=crops, points=points)


def fetch(result):
    """What the consumer takes off the card: the page crops and labels,
    the region crops and gaussians, and a sparse slice of the pages and
    region pages (the whole batch is done when they have arrived)."""
    taken = [result.images[:, ::128, ::128, 0].cpu()]
    if result.num_crops:
        n = result.num_crops
        taken += [result.crop_images[:n].cpu(), result.crop_labels[:n].cpu()]
    regions = result.text_regions
    if regions is not None:
        taken.append(regions.images[:, ::128, ::128, 0].cpu())
        if regions.crop_images is not None:
            n = regions.num_crops
            taken += [regions.crop_images[:n].cpu(),
                      regions.crop_gaussians[:n].cpu()]
    return taken


class BatchSeeds:
    """Stands in for a stream's rng, which draws each batch's child seed
    with ``integers(0, 2**63 - 1)`` (``synthesize_stream``): it gives
    ``first``, then ``seeds`` in a cycle."""

    def __init__(self, first, seeds):
        self.first = int(first)
        self.seeds = [int(s) for s in seeds]
        self.taken = 0

    def integers(self, low, high=None):
        seed = (self.first if self.taken == 0
                else self.seeds[(self.taken - 1) % len(self.seeds)])
        self.taken += 1
        return seed


def child_seeds(seed: int, count: int):
    """The first ``count`` child seeds a stream drawn from ``seed`` gives
    its batches."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 2**63 - 1)) for _ in range(count)]


def make_stream(run, planner):
    """The program's stream: the checked batch, then the pool in a
    cycle."""
    from vkit_tpu_torch.synth import (
        CropConfig,
        RegionStreamConfig,
        synthesize_stream,
    )

    config = run.config
    params = run.params
    pool = child_seeds(params['pool_seed'], params['pool_batches'])
    checked = pool[int(np.random.default_rng([run.seed, 7]).integers(
        len(pool)))]
    return synthesize_stream(
        planner, config['batch'], config['level'], BatchSeeds(checked, pool),
        num_batches=NUM_BATCHES, prefetch=run.params['prefetch'],
        crop_config=CropConfig(core_size=config['crop_core'],
                               num_per_page=config['crops_per_page']),
        region_config=RegionStreamConfig(
            page_size=config['region_page'],
            target_char_height=config['target_char_height'],
            num_crops_per_page=config['region_crops_per_page'],
            crop_size=config['region_crop']),
        keep_on_device=True, device=run.device)


def warm_up(stream, seed: int):
    """The one batch before the window, the checked one, with the check's
    hooks; returns what the check reads of it."""
    with Capture(seed) as capture:
        checked = next(stream)
        kept = keep_result(checked)
    fetch(checked)
    return dict(kept, pages=capture.pages, host_pages=capture.host_pages,
                assembled=capture.assembled, warp=capture.warp,
                flatten=capture.flatten)


def window(run, stream):
    """The measured window."""
    from cardbench.stats import RateWindow, percentile

    batch = run.config['batch']
    run.synchronize()
    rate = RateWindow(run.seconds)
    rate.begin(run.open_window())
    units = 0
    more = True
    while more:
        with run.measure('batch'):
            result = next(stream)
        with run.measure('fetch'):
            fetch(result)
        del result
        rate.done(batch, time.perf_counter())
        units += 1
        more = run.keep_going(rate)
    run.close_window()
    run.units = units
    run.attempted = units * batch
    run.end_to_end['images_per_s'] = rate.rate()
    run.end_to_end['gap_p95_ms'] = percentile(rate.gaps(), 95) * 1e3
    run.end_to_end['peak_mem_gib'] = run.window_peak / 2**30


def readings(checked, device, control: bool = False) -> dict:
    """The compared numbers of the checked batch (with ``control``, of the
    reference computed in bfloat16 in the program's place)."""
    import torch

    from cardbench import reference as R
    from cardbench import synth_reference as S

    plans, src, out = checked['warp']
    geoms = [S.page_geometry(plan) for plan in plans]
    gaps = R.warp_gaps(geoms, src, out, device, planes=PLANES,
                       control=control)
    worst = 0.0
    for geom, before, after in zip(geoms, checked['pages'],
                                   checked['points']):
        if not before:
            continue
        want = R.geometry_points(geom, np.concatenate(before), device)
        got = (R.geometry_points(geom, np.concatenate(before), device,
                                 torch.bfloat16)
               if control else np.concatenate(after))
        worst = max(worst, float(np.abs(got - want).max()))
    crops = checked['crops']
    wrong = None
    if crops is not None:
        size = crops['crops'][0].shape[1]
        wrong = S.crop_mismatches(crops['pages'], crops['crops'],
                                  crops['page_ids'], crops['windows'], size)
        if control:
            wrong = S.crop_mismatches(
                crops['pages'], crops['crops'], crops['page_ids'],
                crops['windows'] + 1, size)
    assembled = (S.assemble_pages(checked['host_pages'], torch.bfloat16)
                 if control else torch.as_tensor(checked['assembled']))
    wrong_pct, worst_lsb = S.assemble_mismatches(
        assembled, S.assemble_pages(checked['host_pages']))
    print(f'check assemble_pct {wrong_pct:.4f} largest {worst_lsb} LSB',
          file=sys.stderr)
    flat = [S.flatten_gap(r['patch'], r['out'], r['angle'], r['scale'],
                          r['extent'], r['out_extent'], device, control)
            for r in checked['flatten']]
    page_gaps = [None if g is None else round(g, 4) for g in gaps]
    print(f'check pages warp_lsb {page_gaps}', file=sys.stderr)
    return {
        'assemble_pct': wrong_pct,
        'warp_lsb': max((g for g in gaps if g is not None), default=None),
        'crop_px': wrong,
        'flatten_lsb': max((g for g in flat if g is not None),
                           default=None),
        'points_px': worst,
    }


def run(run, control: bool = False):
    """One run of the cell; with ``control`` the readings of the bfloat16
    control land in ``run.control``."""
    from vkit_tpu_torch.synth.prep import SynthPlanner, SynthPlannerConfig

    CACHE.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix='synth_assets_', dir=CACHE)
    try:
        assets = synth_assets.build_assets(root,
                                           synth_assets.find_font(root))
        planner = SynthPlanner(SynthPlannerConfig(
            **synth_assets.planner_config(assets, run.config['side'])))
        stream = make_stream(run, planner)
        try:
            checked = warm_up(stream, run.seed)
            window(run, stream)
        finally:
            stream.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device()
    for name, value in readings(checked, run.device).items():
        run.check(name, value)
    if control:
        run.control = readings(checked, run.device, control=True)
