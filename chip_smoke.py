#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vkit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --pipeline-area SIDE]

``--kernels-only`` stops after phase 3 (to time the kernels of two
revisions in turns within one call); ``--pipeline-area SIDE`` runs phase 8
(a) and (c) alone after phase 3 on SIDE x SIDE pages (2522 is the
pipeline's default page), for at most 15 minutes of attempts.  Neither
prints a final result line.

Phases, one line each (plus detail lines):
  1. environment: torch / CUDA versions, the card's name and power limit,
     the host libraries the port's host layers need, the font, and the
     native geometry library; every module of vkit_tpu_torch is imported,
     and the phase fails if that loaded jax or any vkit_tpu module;
  2. build: nvcc builds the CUDA kernels from vkit_tpu_torch/ops/csrc
     (one process per source, all started together), and a detail line
     gives ptxas's registers, shared memory and spills of each K3
     instantiation (its -Xptxas -v output, kept with the build);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card (max abs difference), and its time beside the plain version's,
     one library call's (`library_ms`, where one PyTorch call computes the
     same function) and its bound (the bytes the call must move over the
     card's memory rate, or its operations over the float32 rate).  K1
     (row_shift_window_slab) and K3 (banded_line_resample) run at the
     arguments of their first launch in one synth-640 batch (the page
     warp's), captured there with their launches per batch; K1 also at its
     largest launch of another shape in that batch (the region flatten's),
     at starts that wrap mod 2048, and K3 at each rung of its tap ladder
     and at the shapes of K3_EDGE_CASES (with the source also one float
     off 16-byte alignment), the last three for exactness only
     (bit-exactness logged), and K3's library yardstick
     F.grid_sample on one-row images, which computes K3's function where
     both weighted taps lie in [0, taps) (K3_OUT_OF_BAND; the count of
     outputs out of band is logged).  K4 (row_shift_window), which no path
     calls, runs at K1's captured rows' RGB planes, one plane per row; K2
     (row_shift), which only the spread split routes, at a 1400-lane
     source cut to 700 outputs, and for exactness at odd widths, the widest
     output, starts that clamp and rows off 16-byte alignment.  The
     two-shear warp's slab and blend kernels (quadrant_slab, line_blend),
     bit for bit, at the launches of one warp of the rotate cell (32 x
     640x640x5, rotate plans 73-89 degrees either way: the slab and both
     passes' blends) and at the region flatten's largest launches of the
     captured batch, with their times and bounds.  Then the
     row-shift launches of phase 6's other two paths, recorded in one call
     each on the inputs phase 6 rebuilds from the same seeds (both passes
     of the one-program chain at 64 x 640x640x3 and of the dense warp at 8 x
     640x640x5), each bit for bit against its plain version, with its times
     and bound on a line of its own;
  4. main path: full-content 640x640 pages through synthesize_stream as
     bench config 6 calls it (batch 8, level 5, two 512x512 crops per
     page, the photometric stage on as by default, the text-region stream
     on: stacked 640x640 region pages, two 320x320 region crops per stacked
     page, everything kept on the device), RandomDistortion at bench
     config 5's shape (32 x
     640x640 uint8 + 2 label channels: the photometric stage, then the
     geometric plans rescaled to 704x704 and one batched_plan_warp), the
     random geometric distortion of 32 x 640x640 x 5 channels, and two-page
     spreads (640 x 1400) split into deskewed single pages by
     batched_plan_warp.  Launch counters are zeroed just before and read
     just after; K1-K3 must have launched.  Outputs must be finite with the
     expected shapes, and 320x320 batches on the card must agree with the
     same batches on the CPU: synthesis with the photometric stage off, and
     the text-region stream on (stacked pages within 1 LSB but for
     outline pixels), and the photometric stage restricted to its
     deterministic ops.  Then, outside the counted run: the stream with
     the text-region stream off (the earlier main path's rate), one batch
     with char gaussian maps, two synth-640 batches each under
     device_trace (the card's busy time and share of the batch's window,
     timed by CUDA events, and its longest idle gaps; a trace that lacks a
     device record of a launch or copy call, or a counted kernel launch,
     is logged incomplete and its share not measured),
     synthesize_page_batch's own stage spans
     (``region`` and its five sub-spans included), and
     RandomDistortion images/s over bench config 5's step, label
     co-transform and content boxes included (8 warm-ups, 6 timed steps);
  5. photometric catalog: each of the 25 catalog names once over 8 x
     640x640 uint8 with policy-sampled level-5 configs (6 members, 2
     samples passing through), and one round of the one-program catalog
     with a different op per sample.  Deterministic ops are held to the
     same call on the CPU; rng-consuming ops to their configs' moments.
  6. training path: synthesize_stream as phase 4 calls it, char gaussian
     maps on, feeding synth_to_train_batch and train steps of the default
     TextDetectionNet (64-128-256-512, FPN 128, bfloat16) at 8 x 640x640:
     one warm-up step and four more on fresh batches (pages/s over all five
     batches from the stream's first request to the last step, since the
     stream prepares batches ahead while a step runs; s per step), four on
     a repeated batch (s per step alone; its loss must fall), peak device
     memory; the narrow net's float32 forward
     on the card against the CPU; a checkpoint saved from the card and
     restored onto it.  Then the one-program chain (parallel.
     synthesize_batch) at bench config 1's shape (64 x 640x640x3, level 5),
     images/s of a plain loop, and with noise off against the CPU at 320
     px; and batched_plan_warp(mode='dense') on 8 x 640x640x5 with mild
     camera plans, against mode='gather' and against its own CPU run.
     Each of the three runs with the launch counters zeroed just before
     and read just after: K1 and K3 must have launched in training, K1 or
     K2 in the chain and in the dense warp;
  7. multi-device: vkit_tpu_torch.entry.dryrun_multichip on this card in
     one NCCL process group of world size 1 (a FileStore rendezvous): the
     (1, 1, 1) dp x sp x tp mesh, one sharded train step of the default
     bfloat16 net, 8 composed 640x640 pages a dp rank, the dp-sharded
     one-program chain with the labels on its warp plans, a train step on
     them, and the sharded checkpoint round trip.  Launch counters are
     zeroed just before and read just after: K1 must have launched.  It
     logs the dry run's report line, the seconds of its generation and of
     the train step on the generated batch, and the bytes that step handed
     to NCCL all-reduces (gradients and loss counts over dp x sp).  The
     counted run records (copies) the arguments of each row-shift launch;
     after it, each launch is held bit for bit against its plain version,
     with its times and bound on a line of its own;
  8. pipeline: the 17-step text-detection pipeline (vkit_tpu_torch.
     pipeline, as tests/pipeline/fixtures.py configures it: 640x640 pages,
     synth/assets.py's build_step_configs), step 15 flattening its text
     regions on the card.  (a) One sample under the port's PipelineRunner
     from seed 0, the pool's retry: an attempt that step 15's warp planner
     refuses (an AssertionError of ops/warp_mxu.py, the reference's
     behaviour) draws again, any other error fails the phase, and 30
     attempts without a sample fail it.  Launch counters are zeroed just
     before and read just after: K1 must have launched.  It logs each
     attempt (seconds, source-tile buckets, launches, error), samples/s,
     the sample's seconds per step, the regions flattened, the buckets and
     row-shift shapes, and peak device memory; every row-shift launch is
     recorded and held bit for bit against its plain version after the
     run, and the largest of each kernel is timed with its bound.  (b) One
     sample from PipelinePool(pipeline_factory=..., num_processes=2), its
     workers spawned and each with step 15 on the card.  (c) Step 15 again
     from (a)'s input and rng state, on the card and on the CPU: host
     fields equal, rasters within 1 LSB but for outline pixels, and the
     card's run under torch.profiler for its device time;
  9. grid warp and single-image ops: batched_grid_warp at bench configs
     3, 4 and 2 (camera and MLS at 32 x 640x640x5, rotate 17 degrees at
     64 x 640x640x5; RGB, a mask and a score map), each with the launch
     counters zeroed just before and read just after (K3 must launch for
     camera and MLS, K1 for rotate), held to the same call on the CPU within
     1 LSB inside each sample's coverage eroded by 4 px, and timed (median
     of 5 calls after 2 warm-ups), each case's largest launch timed with
     its bound (K3 also at each stage size); the camera call 5 times
     more, each
     under device_trace (busy time and share, as in phase 4, and the top
     device operations); then the reference's single-image ops at 640x640
     on the card against the CPU (warp_perspective once with a numpy
     matrix, whose maps must be built on the card), each within its
     tolerance, with its ms.  A detail line counts K3's launches over
     phases 4-9 by (N, L, C, W, JP, taps).
Then one JSON line of per-kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Any failure raises (exit code != 0).
`launches` in the JSON line sums the counted runs of phases 4, 6, 7, 8 and 9
(`launches_by_path` has each), so K4 reads 0; the launches of one synth-640
batch are on phase 3's capture line.
Parity with the CPU assumes TF32 off for matmuls and cuDNN, as set here.
The script needs a CUDA card and the rest of the repository beside it.
"""
import collections
import importlib
import importlib.metadata
import importlib.util
import json
import pkgutil
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
ASSETS = REPO / 'build' / 'chip_smoke_assets'
KERNEL_SOURCES = {
    'row_shift_window_slab': ('vkit_tpu_torch/ops/csrc/row_shift.cu',
                              'vkit_tpu/ops/pallas_kernels.py:157'),
    'row_shift': ('vkit_tpu_torch/ops/csrc/row_shift.cu',
                  'vkit_tpu/ops/pallas_kernels.py:26'),
    'banded_line_resample': ('vkit_tpu_torch/ops/csrc/banded_resample.cu',
                             'vkit_tpu/ops/pallas_kernels.py:341'),
    'row_shift_window': ('vkit_tpu_torch/ops/csrc/row_shift.cu',
                         'vkit_tpu/ops/pallas_kernels.py:136'),
    # No TPU kernel: XLA fuses this work of vkit_tpu/ops/warp_mxu.py.
    'quadrant_slab': ('vkit_tpu_torch/ops/csrc/two_shear.cu',
                      'none (XLA: vkit_tpu/ops/warp_mxu.py:407)'),
    'line_blend': ('vkit_tpu_torch/ops/csrc/two_shear.cu',
                   'none (XLA: vkit_tpu/ops/warp_mxu.py:164)'),
}
# The kernels the main path runs; K4 has no caller on any path.
MAIN_PATH_KERNELS = ('row_shift_window_slab', 'row_shift',
                     'banded_line_resample', 'quadrant_slab', 'line_blend')
# The kernels of the stream that feeds training (no spread split there).
TRAINING_PATH_KERNELS = ('row_shift_window_slab', 'banded_line_resample')
# The card's published peaks (H100 SXM data sheet): device memory bytes/s,
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# K3's yardstick, F.grid_sample on one-row images, computes K3's function
# only where both weighted taps lie in [0, taps): K3 drops a tap outside
# that band, grid_sample reads it.  It must agree there within 1e-4 plus
# the position error of its normalised grid (x -> 2x / (W - 1) - 1 and
# back, a few float32 roundings of numbers up to W) times the steepest
# step of the row next to the position; this bound's position error, 8
# float32 ulps of W, is 5x the 6.1e-5 px measured on a CPU at W = 640.
K3_OUT_OF_BAND = ('outputs with a weighted tap outside [0, taps): K3 masks '
                  'it, grid_sample reads it')
K3_LIBRARY_TOL = 1e-4
# K3's exactness cases beside the captured call, (N, L, C, W, JP, taps):
# C * W % 4 != 0 with L = 13, one channel (8 lines an item), nine channels
# (the runtime channel loop), the widest row, a line split into channel
# chunks.  The captured call (2,560 items, several a persistent block)
# runs each tap rung.
K3_EDGE_CASES = (
    (2, 13, 5, 641, 768, 64),
    (3, 24, 1, 300, 256, 32),
    (2, 16, 9, 640, 640, 128),
    (2, 9, 3, 1664, 1664, 32),
    (1, 8, 16, 1664, 384, 64),
)
# Share of a stacked region page's pixels that may differ between the card
# and the CPU: the polygon test, the warped alpha and the coverage each
# threshold a float32 value, so a last-bit difference flips a pixel on a
# region's outline.
REGION_EDGE_SHARE = 2e-3
# Photometric ops that round an HSV / HSL intermediate to uint8.
HSV_ROUNDING = frozenset({'color_shift', 'brightness_shift'})


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log_text: str, kernel: str = 'banded_resample_kernel'):
    """nvcc -Xptxas -v's registers / barriers / shared memory line and its
    spill line for each instantiation of ``kernel`` (K3's template
    argument: the channels unrolled, 0 for the runtime loop).  Returns
    {channels: 'Used ... ; ... spill ...'}."""
    found, current, spill = {}, None, ''
    for line in log_text.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([A-Za-z0-9_]+)", line)
        if entry:
            args = re.search(kernel + r'ILi(\d+)E', entry.group(1))
            current = int(args.group(1)) if args else None
            continue
        if current is None:
            continue
        if 'spill stores' in line:
            spill = line.strip()
        elif 'Used' in line and 'registers' in line:
            found[current] = line.split(':', 1)[1].strip() + '; ' + spill
            current, spill = None, ''
    return found


# ---------------------------------------------------------------------------
# Phase 1: environment.
# ---------------------------------------------------------------------------


def probe_host_libraries():
    found = {}
    for module, dist in (('PIL', 'pillow'), ('attr', 'attrs'),
                         ('scipy', 'scipy')):
        check(importlib.util.find_spec(module) is not None,
              f'host library {module} is missing')
        found[module] = importlib.metadata.version(dist)
    return found


def import_the_port() -> int:
    """Imports every module of vkit_tpu_torch; fails if that loaded jax,
    flax, optax, orbax, sklearn or any vkit_tpu module.  Returns the module
    count."""
    import vkit_tpu_torch

    names = [info.name for info in pkgutil.walk_packages(
        vkit_tpu_torch.__path__, 'vkit_tpu_torch.')]
    for name in names:
        importlib.import_module(name)
    loaded = sorted(name for name in sys.modules if name.split('.')[0] in
                    ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn',
                     'vkit_tpu'))
    check(not loaded, f'importing the port loaded {loaded[:8]}')
    return len(names)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """CUDA-event time of one call: the median over ``reps`` windows of
    ``inner`` back-to-back calls, each window's time over ``inner`` (after
    a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def check_exact(name, kernel_fn, plain_fn, tol: float):
    """Kernel output against the plain version's; returns the max abs
    difference and whether the two are bit-identical."""
    import torch

    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f'{name}: shape {got.shape} != {ref.shape}')
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    check(err <= tol, f'{name}: max abs err {err} > {tol}')
    return err, bool(torch.equal(got, ref))


def bound(bytes_moved: float, operations: float = 0.0):
    """(least ms the card could take, what bounds it): the bytes over the
    memory rate or the float32 operations over their rate, the larger."""
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = operations / PEAK_F32_PER_S * 1e3
    return (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')


def compare(name, kernel_fn, plain_fn, tol: float, work, library_fn=None,
            library_close=None):
    """Max abs difference of kernel and plain outputs, and the times of
    kernel, plain version and library call, measured in turns (plain,
    kernel, library, library, kernel, plain).  ``work`` is (bytes,
    operations) of the call; the library call must equal the plain
    version bit for bit, or pass ``library_close(library output, plain
    output)``."""
    import torch

    err, exact = check_exact(name, kernel_fn, plain_fn, tol)
    if library_fn is not None:
        same = (torch.equal(library_fn(), plain_fn()) if library_close is None
                else library_close(library_fn(), plain_fn()))
        check(same, f'{name}: the library call computes something else')
    plain_a = time_ms(plain_fn)
    kern_a = time_ms(kernel_fn)
    lib_a = time_ms(library_fn) if library_fn is not None else None
    lib_b = time_ms(library_fn) if library_fn is not None else None
    kern_b = time_ms(kernel_fn)
    plain_b = time_ms(plain_fn)
    bound_ms, bound_by = bound(*work)
    ms = statistics.mean((kern_a, kern_b))
    return {
        'max_abs_err': err, 'bit_exact': exact, 'ms': ms,
        'plain_ms': statistics.mean((plain_a, plain_b)),
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': (statistics.mean((lib_a, lib_b))
                       if library_fn is not None else None),
        'share': bound_ms / ms, 'bytes': work[0], 'operations': work[1],
    }


def copy_call(args, kwargs):
    """A wrapper call's arguments with every tensor cloned."""
    import torch

    return ([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
            dict(kwargs))


def record_row_shifts(run):
    """Calls ``run()`` with recorders around the K1 and K2 wrappers that
    ops/warp_mxu.py calls (the affine and the dense two-pass reach them
    there).  Returns [(kernel, args, kwargs)], one entry per launch in call
    order, copied.  The copies launch no kernel, so a counted run may be
    recorded; they add a copy of each launch's inputs to its time."""
    from vkit_tpu_torch.ops import warp_mxu

    return record_calls(run, warp_mxu, ('row_shift_window_slab', 'row_shift'))


def record_calls(run, module, names):
    """record_row_shifts for the wrappers ``names`` as ``module`` calls
    them."""
    originals = {name: getattr(module, name) for name in names}
    calls = []

    def recorder(name):
        def record(*args, **kwargs):
            calls.append((name,) + copy_call(args, kwargs))
            return originals[name](*args, **kwargs)
        return record

    for name in names:
        setattr(module, name, recorder(name))
    try:
        run()
    finally:
        for name in names:
            setattr(module, name, originals[name])
    return calls


def count_banded_shapes():
    """Counts K3's launches on the card by (N, L, C, W, JP, taps) where
    ops/warp_banded.py calls it.  Returns (the counter, a function that
    puts the wrapper back)."""
    from vkit_tpu_torch.ops import warp_banded

    shapes = collections.Counter()
    real = warp_banded.banded_line_resample

    def counted(x, base, pos, taps, *args, **kwargs):
        if x.is_cuda:
            shapes[(*x.shape, pos.shape[-1], taps)] += 1
        return real(x, base, pos, taps, *args, **kwargs)

    warp_banded.banded_line_resample = counted

    def restore():
        warp_banded.banded_line_resample = real

    return shapes, restore


def capture_main_path_args(device, planner, seed: int = 400, batch: int = 8,
                           side: int = 640):
    """Runs one synth-640 batch (level 5, two crops per page, photometric
    stage and text-region stream on) with recorders around the K1, K3,
    slab and blend wrappers that ops/warp_mxu.py and ops/warp_banded.py
    call.  Returns {kernel: (args, kwargs) of its first launch, copied},
    under '<kernel>/flatten' the largest launch of another shape of K1,
    the slab and the blend (the region flatten's), and the batch's
    launches per kernel.  Untimed, and outside the counted main-path
    run."""
    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.ops import warp_banded, warp_mxu
    from vkit_tpu_torch.synth import (
        CropConfig,
        RegionStreamConfig,
        synthesize_page_batch,
    )

    captured = {}
    sites = ((warp_mxu, 'row_shift_window_slab'),
             (warp_banded, 'banded_line_resample'),
             (warp_mxu, 'quadrant_slab'), (warp_mxu, 'line_blend'))
    with_flatten = ('row_shift_window_slab', 'quadrant_slab', 'line_blend')
    originals = [getattr(module, name) for module, name in sites]

    def recorder(name, real):
        flatten = f'{name}/flatten'

        def record(*args, **kwargs):
            if name not in captured:
                captured[name] = copy_call(args, kwargs)
            elif (name in with_flatten
                  and args[0].shape != captured[name][0][0].shape
                  and (flatten not in captured or args[0].numel()
                       > captured[flatten][0][0].numel())):
                captured[flatten] = copy_call(args, kwargs)
            return real(*args, **kwargs)
        return record

    rng = np.random.default_rng(seed)
    crop = CropConfig(core_size=side * 4 // 5, num_per_page=2)
    before = dict(K.LAUNCHES)
    for attempt in range(5):
        pages = planner.prepare_batch(batch, rng)
        for (module, name), real in zip(sites, originals):
            setattr(module, name, recorder(name, real))
        try:
            synthesize_page_batch(
                pages, 5, rng, crop_config=crop,
                region_config=RegionStreamConfig(num_crops_per_page=2),
                keep_on_device=True, device=device)
            sync(device)
        finally:
            for (module, name), real in zip(sites, originals):
                setattr(module, name, real)
        launches = {name: K.LAUNCHES[name] - before[name]
                    for name in K.LAUNCHES}
        if len(captured) == len(sites) + len(with_flatten):
            return captured, launches
        log(f'    capture batch {attempt}: launches {launches}; '
            'drawing another batch')
        captured.clear()
        before = dict(K.LAUNCHES)
    raise RuntimeError('chip_smoke: no synth-640 batch launched K1, the '
                       'slab and the blend (page warp and region flatten) '
                       'and K3')


def window_read_floats(starts, width: int, out_width: int) -> int:
    """Source floats per channel that K1 / K4 must read: each row's window
    of 2048 lanes, starting at lane starts mod 2048, overlaps the row in
    one interval [lo, hi)."""
    import torch

    from vkit_tpu_torch.ops.kernels import WINDOW

    a = starts.to(torch.int64) & (WINDOW - 1)
    inside = a < width
    lo = torch.where(inside, a, 0)
    hi = torch.where(inside, (a + out_width).clamp(max=width),
                     (a + out_width - WINDOW).clamp(0, width))
    return int((hi - lo).clamp(min=0).sum())


def window_gather_library(x, starts, out_width: int, border: float):
    """K1 / K4's library yardstick: one torch.gather over the source padded
    with one border column, at an index computed beforehand."""
    import torch
    import torch.nn.functional as F

    from vkit_tpu_torch.ops.kernels import WINDOW

    width = x.shape[-1]
    x_pad = F.pad(x, (0, 1), value=border)
    j = torch.arange(out_width, device=x.device)
    k = torch.remainder(starts.to(torch.int64)[..., None] + j, WINDOW)
    idx = torch.where(k < width, k, width)
    if x.dim() == 4:
        idx = idx[:, :, None, :].expand(-1, -1, x.shape[2], -1)
    idx = idx.contiguous()
    return lambda: torch.gather(x_pad, x.dim() - 1, idx)


def window_work(x, starts, out_width: int):
    """(bytes, operations) of one K1 / K4 call: the source floats the
    windows overlap, the starts and the output, each once; no arithmetic
    on the data."""
    channels = x.shape[2] if x.dim() == 4 else 1
    rows = starts.numel()
    floats = (channels * window_read_floats(starts, x.shape[-1], out_width)
              + rows + rows * channels * out_width)
    return 4.0 * floats, 0.0


def shift_work(x_padded, starts, out_width: int):
    """(bytes, operations) of one K2 call: each row's span of ``out_width``
    lanes at its start (indices clamp into the row), the starts and the
    output, each once; no arithmetic on the data."""
    import torch

    m_padded = x_padded.shape[-1]
    first = starts.to(torch.int64).clamp(0, m_padded - 1)
    last = (starts.to(torch.int64) + out_width - 1).clamp(0, m_padded - 1)
    floats = (int((last - first + 1).sum()) + starts.numel()
              + starts.numel() * out_width)
    return 4.0 * floats, 0.0


def shift_gather_library(x_padded, starts, out_width: int):
    """K2's library yardstick: one torch.gather at an index computed
    beforehand."""
    import torch

    j = torch.arange(out_width, device=x_padded.device)
    idx = (starts.to(torch.int64)[..., None] + j).clamp(
        0, x_padded.shape[-1] - 1)
    return lambda: torch.gather(x_padded, 2, idx)


def compare_row_shift(label: str, name: str, args, kwargs):
    """compare() of one recorded K1 or K2 launch, which must be bit-exact."""
    from vkit_tpu_torch.ops import kernels as K

    x, starts, width = args
    if name == 'row_shift_window_slab':
        border = float(kwargs.get('border_value', 0.0))
        result = compare(
            label,
            lambda: K.row_shift_window_slab(x, starts, width, border),
            lambda: K.row_shift_window_slab_plain(x, starts, width, border),
            tol=0.0, work=window_work(x, starts, width),
            library_fn=window_gather_library(x, starts, width, border))
    else:
        check(name == 'row_shift', f'{label}: recorded {name}')
        result = compare(
            label,
            lambda: K.row_shift(x, starts, width),
            lambda: K.row_shift_plain(x, starts, width),
            tol=0.0, work=shift_work(x, starts, width),
            library_fn=shift_gather_library(x, starts, width))
    check(result['bit_exact'], f'{label}: not bit-exact')
    result['shape'] = f'{tuple(x.shape)} -> {width}'
    return result


def banded_work(x, base, pos, taps: int):
    """(bytes, operations) of one K3 call: the source floats that carry
    weight in some output (the two taps floor(u), floor(u) + 1 inside [0,
    taps) and inside the row), base, pos and the output, each once; the
    hat weights (12 operations per (line, output)) and the blend (3 per
    channel)."""
    import torch

    from vkit_tpu_torch.ops.kernels import ROW_OFFSET, WINDOW

    n, lines, channels, width = x.shape
    jp = pos.shape[-1]
    j = torch.arange(jp, device=x.device)
    b = base.repeat_interleave(8, dim=1)[:, :lines].repeat_interleave(
        128, dim=2).to(torch.int64)
    u = pos - (b.to(torch.float32) + (j % 128).to(torch.float32))
    t0f = torch.floor(u)
    t0 = t0f.to(torch.int64)
    needed = torch.zeros((n * lines, width + 1), dtype=torch.uint8,
                         device=x.device)
    for t, tap in ((t0, t0f), (t0 + 1, t0f + 1.0)):
        live = (t >= 0) & (t < taps) & ((u - tap).abs() < 1.0)
        col = torch.remainder(b + j % 128 + t + ROW_OFFSET, WINDOW) - ROW_OFFSET
        ok = live & (col >= 0) & (col < width)
        idx = torch.where(ok, col, width).reshape(n * lines, jp)
        needed.scatter_(1, idx, 1)
    reads = int(needed[:, :width].sum())
    floats = (channels * reads + base.numel() + pos.numel()
              + n * lines * channels * jp)
    return 4.0 * floats, float(n * lines * jp * (12 + 3 * channels))


def banded_grid_sample_library(x, base, pos, taps: int, border: float):
    """K3's library yardstick: one F.grid_sample (bilinear, zero padding,
    align_corners) over the source rows as (N * L, C, 1, W) images shifted
    by the border value, at a grid built beforehand from ``pos``.  Returns
    (the timed call, its check against the plain version on the in-band
    outputs, the count of out-of-band outputs, a dict that the check fills
    with its max abs difference in band)."""
    import torch
    import torch.nn.functional as F

    from vkit_tpu_torch.ops.kernels import _window_taps

    n, lines, channels, width = x.shape
    jp = pos.shape[-1]
    rows = (x - border).reshape(n * lines, channels, 1, width).contiguous()
    grid = torch.zeros((n * lines, 1, jp, 2), dtype=torch.float32,
                       device=x.device)
    grid[..., 0] = (pos.to(torch.float64) * (2.0 / (width - 1)) - 1.0).to(
        torch.float32).reshape(n * lines, 1, jp)
    lane = torch.arange(jp, device=x.device) % 128
    b = base.repeat_interleave(8, dim=1)[:, :lines].repeat_interleave(
        128, dim=2).to(torch.int64)
    u = pos - (b + lane).to(torch.float32)
    t0f = torch.floor(u)
    in_band = ((t0f >= 0) & ((t0f + 1 < taps) | (u == t0f)))[:, :, None, :]
    k0 = b + lane + t0f.to(torch.int64)
    # The steepest step of the interpolant within a position error of
    # pos: grid_sample may land just below an integer pos.
    v0 = _window_taps(x, k0, border)
    step = torch.maximum((_window_taps(x, k0 + 1, border) - v0).abs(),
                         (v0 - _window_taps(x, k0 - 1, border)).abs())
    del v0
    bound = K3_LIBRARY_TOL + 8 * 2.0 ** -24 * width * step
    found = {}

    def close(got, want):
        diff = (got.reshape(n, lines, channels, jp) + border - want).abs()
        inside = in_band.expand_as(diff)
        found['max_abs_err'] = float(diff[inside].max())
        return bool((diff <= bound)[inside].all())

    def library():
        return F.grid_sample(rows, grid, mode='bilinear',
                             padding_mode='zeros', align_corners=True)

    return library, close, int((~in_band).sum()), found


def kernel_phase(device, captured):
    """Each kernel against its plain version; K1 and K3 timed at the
    captured main-path arguments."""
    import torch
    import torch.nn.functional as F

    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.ops.warp_mxu import (
        apply_line_resample,
        plan_line_resample,
    )
    from vkit_tpu_torch import convert

    gen = np.random.default_rng(1)
    results = {}

    # K1 at its first launch in a synth-640 batch.
    (x, starts, ow), kwargs = captured['row_shift_window_slab']
    border = float(kwargs.get('border_value', 0.0))
    results['row_shift_window_slab'] = compare(
        'row_shift_window_slab',
        lambda: K.row_shift_window_slab(x, starts, ow, border),
        lambda: K.row_shift_window_slab_plain(x, starts, ow, border),
        tol=0.0, work=window_work(x, starts, ow),
        library_fn=window_gather_library(x, starts, ow, border),
    )
    results['row_shift_window_slab']['shape'] = (
        f'{tuple(x.shape)} -> {ow}')
    # Exactness only: starts anywhere in +-896, most windows mostly border,
    # some wrapping mod 2048 back into the row.
    span = K.WINDOW - x.shape[-1] - ow
    wrap = torch.from_numpy(
        gen.integers(-span, span + 1, tuple(starts.shape)).astype(np.int32)
    ).to(device)
    _, exact = check_exact(
        'row_shift_window_slab wrap',
        lambda: K.row_shift_window_slab(x, wrap, ow, border),
        lambda: K.row_shift_window_slab_plain(x, wrap, ow, border), tol=0.0)
    check(exact, 'row_shift_window_slab wrap: not bit-exact')

    # K1 at its largest launch in the region flatten of that batch.
    (xf, sf, owf), kwargs = captured['row_shift_window_slab/flatten']
    border_f = float(kwargs.get('border_value', 0.0))
    results['row_shift_window_slab/flatten'] = compare(
        'row_shift_window_slab (region flatten)',
        lambda: K.row_shift_window_slab(xf, sf, owf, border_f),
        lambda: K.row_shift_window_slab_plain(xf, sf, owf, border_f),
        tol=0.0, work=window_work(xf, sf, owf),
        library_fn=window_gather_library(xf, sf, owf, border_f),
    )
    results['row_shift_window_slab/flatten']['shape'] = (
        f'{tuple(xf.shape)} -> {owf}')
    del xf, sf

    # K4 at the captured rows' RGB planes, one plane per row.
    x4 = x[:, :, :3].reshape(x.shape[0], x.shape[1] * 3, x.shape[3])
    s4 = starts.repeat_interleave(3, dim=1).contiguous()
    results['row_shift_window'] = compare(
        'row_shift_window',
        lambda: K.row_shift_window(x4, s4, ow, border),
        lambda: K.row_shift_window_plain(x4, s4, ow, border),
        tol=0.0, work=window_work(x4, s4, ow),
        library_fn=window_gather_library(x4, s4, ow, border),
    )
    results['row_shift_window']['shape'] = f'{tuple(x4.shape)} -> {ow}'
    wrap4 = wrap.repeat_interleave(3, dim=1).contiguous()
    _, exact = check_exact(
        'row_shift_window wrap',
        lambda: K.row_shift_window(x4, wrap4, ow, border),
        lambda: K.row_shift_window_plain(x4, wrap4, ow, border), tol=0.0)
    check(exact, 'row_shift_window wrap: not bit-exact')
    del x4, s4, wrap, wrap4

    # K2 through apply_line_resample: a 1400-lane source resampled to 700
    # outputs fails the 2048-lane window (m_in + m_shift > 2048).
    n, lines, c, m_in, m_out = 8, 640, 7, 1400, 700
    slopes = 1.0 + gen.uniform(-0.002, 0.002, n)
    offsets = (gen.uniform(0, 690, (n, 1))
               + np.linspace(0, 12, lines)[None, :])
    plan, statics = plan_line_resample(slopes, offsets, m_in, m_out)
    check(m_in + statics.m_shift > K.WINDOW,
          f'K2 statics {statics} fit the window')
    plan_t = convert.line_resample_plan(plan, device)
    xs = torch.from_numpy(
        gen.random((n, lines, c, m_in), dtype=np.float32) * 255
    ).to(device)
    before = K.LAUNCHES['row_shift']
    out = apply_line_resample(xs, plan_t, statics, border_value=255.0)
    torch.cuda.synchronize()
    check(K.LAUNCHES['row_shift'] == before + 1,
          'apply_line_resample did not take the row_shift route')
    check(bool(torch.isfinite(out).all()), 'apply_line_resample not finite')
    del out
    x_p = F.pad(xs, (statics.pad_lo,
                     statics.m_padded - m_in - statics.pad_lo),
                value=255.0).reshape(n, lines * c, statics.m_padded)
    rows = plan_t.starts[:, :, None].expand(n, lines, c).reshape(
        n, lines * c).to(torch.int32).contiguous()
    del xs
    results['row_shift'] = compare_row_shift(
        'row_shift', 'row_shift', (x_p, rows, statics.m_shift), {})
    log(f'    row_shift statics: {statics}')
    del x_p, rows
    # Exactness only: widths that are no multiple of 4, the widest output,
    # the narrowest padded row, starts outside the contract (each index
    # clamps into its row), and rows one float off 16-byte alignment.
    for m_p, width, kind in ((1536, 401, 'contract'), (1536, 896, 'contract'),
                             (1024, 640, 'zero'), (1100, 3, 'contract'),
                             (1280, 702, 'outside')):
        shape = (3, 517, m_p)
        if kind == 'zero':
            st = np.zeros(shape[:2], np.int32)
        elif kind == 'contract':
            st = gen.integers(0, m_p - K.ROLL_WINDOW + 1, shape[:2])
        else:
            st = gen.integers(-2 * m_p, 2 * m_p, shape[:2])
            st[0, :4] = (-1, m_p - width + 1, 2**31 - 1, -2**31)
        st = torch.from_numpy(st.astype(np.int32)).to(device)
        flat = torch.from_numpy(
            gen.random(int(np.prod(shape)) + 1, dtype=np.float32)).to(device)
        for xk, label in ((flat[:-1].view(shape), 'aligned'),
                          (flat[1:].view(shape), 'off by one float')):
            _, exact = check_exact(
                f'row_shift {m_p} -> {width} {kind} {label}',
                lambda: K.row_shift(xk, st, width),
                lambda: K.row_shift_plain(xk, st, width), tol=0.0)
            check(exact, f'row_shift {m_p} -> {width} {kind} {label}: not '
                  'bit-exact')
    del flat, st

    # K3 at its first launch in a synth-640 batch.
    (xb, base, pos, taps), kwargs = captured['banded_line_resample']
    border = float(kwargs.get('border_value', 0.0))
    library, close, out_of_band, found = banded_grid_sample_library(
        xb, base, pos, taps, border)
    results['banded_line_resample'] = compare(
        'banded_line_resample',
        lambda: K.banded_line_resample(xb, base, pos, taps, border),
        lambda: K.banded_line_resample_plain(xb, base, pos, taps, border),
        tol=1e-3, work=banded_work(xb, base, pos, taps),
        library_fn=library, library_close=close,
    )
    results['banded_line_resample']['shape'] = (
        f'{tuple(xb.shape)} -> {pos.shape[-1]}, taps {taps}')
    log(f'    banded_line_resample library (F.grid_sample, one-row images): '
        f'max abs err {found["max_abs_err"]} on the in-band outputs; '
        f'{out_of_band} of {pos.numel()} (line, output) pairs out of band '
        f'({K3_OUT_OF_BAND}); border {border}')
    del library, close
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    res = results['banded_line_resample']

    def exact_k3(label, x, base, pos, taps):
        return check_exact(
            label, lambda: K.banded_line_resample(x, base, pos, taps, 255.0),
            lambda: K.banded_line_resample_plain(x, base, pos, taps, 255.0),
            tol=1e-3)

    # Exactness only: each rung of the tap ladder at random bases, then the
    # edge shapes.
    n, lines = xb.shape[:2]
    for rung in (32, 64, 128):
        _, base_r, pos_r = banded_random_case(gen, device, n, lines, 0, 0,
                                              768, rung)
        err, exact = exact_k3(f'banded_line_resample taps={rung}', xb,
                              base_r, pos_r, rung)
        res['max_abs_err'] = max(res['max_abs_err'], err)
        log(f'    banded_line_resample taps={rung}: max_abs_err {err}, bit '
            f'exact {exact}')
    for n, lines, c, width, jp, rung in K3_EDGE_CASES:
        x_e, base_e, pos_e = banded_random_case(gen, device, n, lines, c,
                                                width, jp, rung)
        # The source one float off 16-byte alignment: ragged heads and
        # tails in every item.
        x_off = torch.empty(x_e.numel() + 1, device=device)[1:].view(
            x_e.shape)
        x_off.copy_(x_e)
        label = (f'banded_line_resample {(n, lines, c, width)} -> {jp}, '
                 f'taps {rung}')
        err, exact = exact_k3(label, x_e, base_e, pos_e, rung)
        err_off, exact_off = exact_k3(label + ' (x off 16 bytes)', x_off,
                                      base_e, pos_e, rung)
        res['max_abs_err'] = max(res['max_abs_err'], err, err_off)
        launch = K.banded_launch(n, lines, c, width, sms)
        log(f'    {label}: max_abs_err {max(err, err_off)}, bit exact '
            f'{exact and exact_off} (G {launch.lines_per_item}, '
            f'{launch.chunks} channel chunks, {launch.items} items)')
    torch.cuda.empty_cache()
    return results


def slab_work(images, quadrants=None):
    """(bytes, operations) of one ``quadrant_slab`` call: the images, the
    quadrants and the float32 slab, each once; no arithmetic."""
    floats_out = images.numel()
    turned = quadrants is not None and np.any(quadrants)
    nbytes = (images.numel() * images.element_size() + 4 * floats_out
              + (4 * len(quadrants) if turned else 0))
    return float(nbytes), 0.0


def blend_work(window, i0, frac_j, phi, layout):
    """(bytes, operations) of one ``line_blend`` call: the window lanes
    some tap reads (i0 + {0, 1, 2} of each sample, in every line and
    channel), i0, frac_j, phi and the output, each once; the hat weights
    (6 operations per (line, output)) and the blend (5 per channel)."""
    n, lines, channels, _ = window.shape
    jn = i0.shape[1]
    taps = i0.cpu().numpy().astype(np.int64)
    lanes = sum(len(np.unique(np.concatenate([row, row + 1, row + 2])))
                for row in taps)
    floats = (lanes * lines * channels + 2 * n * jn + n * lines
              + n * lines * channels * jn)
    return 4.0 * floats, float(n * lines * jn * (6 + 5 * channels))


def compare_two_shear(label: str, name: str, args):
    """compare() of one recorded slab or blend launch, which must be
    bit-exact; no library call computes either function."""
    from vkit_tpu_torch.ops import kernels as K

    kernel, plain = getattr(K, name), getattr(K, f'{name}_plain')
    work = slab_work if name == 'quadrant_slab' else blend_work
    result = compare(label, lambda: kernel(*args), lambda: plain(*args),
                     tol=0.0, work=work(*args))
    check(result['bit_exact'], f'{label}: not bit-exact')
    x, detail = args[0], args[1]
    if name == 'line_blend':
        detail = f'-> {detail.shape[1]}, {args[4]}'
    elif detail is not None:
        detail = f'quadrants {np.bincount(detail, minlength=4).tolist()}'
    result['shape'] = f'{tuple(x.shape)} {str(x.dtype)[6:]} {detail}'
    return result


def two_shear_phase(device, captured):
    """The slab and blend kernels against their plain versions, bit for
    bit, with their times and bounds: at the launches of one warp of the
    rotate cell (the slab, pass V's and pass H's blend) and at the region
    flatten's largest launches of a synth-640 batch.  Returns {label:
    compare() result}; 'quadrant_slab' and 'line_blend' are the rotate
    cell's slab and pass V blend."""
    import torch

    from tests.two_shear_cases import rotate_call
    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.ops import warp_mxu

    calls = record_calls(rotate_call(device), warp_mxu,
                         ('quadrant_slab', 'line_blend'))
    sync(device)
    check([name for name, _, _ in calls]
          == ['quadrant_slab', 'line_blend', 'line_blend'],
          f'rotate warp: launches {[name for name, _, _ in calls]}')
    check(set(np.asarray(calls[0][1][1]).tolist()) == {1, 3},
          'rotate warp: quadrants other than 1 and 3')
    results = {}
    for label, (name, args, _) in zip(
            ('quadrant_slab', 'line_blend', 'line_blend/rotate pass H'),
            calls):
        results[label] = compare_two_shear(label, name, args)
    del calls
    torch.cuda.empty_cache()
    for name in ('quadrant_slab', 'line_blend'):
        label = f'{name}/flatten'
        args, kwargs = captured[label]
        check(not kwargs, f'{label}: keyword arguments {kwargs}')
        results[label] = compare_two_shear(f'{name} (region flatten)', name,
                                           args)
        torch.cuda.empty_cache()
    check(K.LAUNCHES['line_blend'] > 0, 'line_blend never launched')
    return results


def banded_random_case(gen, device, n: int, lines: int, channels: int,
                       width: int, jp: int, taps: int):
    """Random K3 inputs: a source of ``channels`` x ``width`` (None when 0),
    bases in [-500, 1281) and positions up to 2 past either end of each
    band, so some taps fall outside [0, taps) and some wrap mod 2048."""
    import torch

    groups = -(-lines // 8)
    base_np = gen.integers(-500, 1281, (n, groups, jp // 128))
    full = np.repeat(np.repeat(base_np, 8, 1)[:, :lines], 128, 2)
    pos_np = (full + np.arange(jp) % 128
              + gen.uniform(-2, taps + 2, (n, lines, jp)))
    x = (torch.from_numpy(
        gen.random((n, lines, channels, width), dtype=np.float32) * 255
    ).to(device) if channels else None)
    return (x, torch.from_numpy(base_np.astype(np.int32)).to(device),
            torch.from_numpy(pos_np.astype(np.float32)).to(device))


def log_kernel(tag: str, name: str, res, card: str):
    log(f'[{tag}] {name} at {res["shape"]}: max_abs_err '
        f'{res["max_abs_err"]} bit_exact {res["bit_exact"]} ms '
        f'{res["ms"]:.4f} plain_ms {res["plain_ms"]:.4f} library_ms '
        + (f'{res["library_ms"]:.4f}' if res['library_ms'] is not None
           else 'none')
        + f' | bound {res["bound_ms"]:.4f} ms by {res["bound_by"]} '
        f'({res["bytes"] / 1e6:.1f} MB, {res["operations"]:.3g} ops), '
        f'share {res["share"]:.3f} | {card}')


def path_kernel_phase(device, chain, stack, plans):
    """The row-shift launches of one call of the one-program chain and of
    the dense warp, at the arguments phase 6 will give them: each recorded
    launch against its plain version bit for bit, with its times and bound.
    Returns {label: compare() result}."""
    import torch

    from vkit_tpu_torch.mechanism.batched import batched_plan_warp

    results = {}
    for path, run in (
            ('chain', chain),
            ('dense', lambda: batched_plan_warp(
                plans, stack, mode='dense', border_value=0.0,
                canvas_shape=DENSE_CANVAS))):
        calls = record_row_shifts(run)
        sync(device)
        check(len(calls) == 2, f'{path}: {len(calls)} row-shift launches in '
              'one call, not the two passes')
        for (name, args, kwargs), which in zip(calls, ('V', 'H')):
            label = f'{name}/{path} pass {which}'
            results[label] = compare_row_shift(label, name, args, kwargs)
        del calls
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 4: the main path.
# ---------------------------------------------------------------------------


def check_synth(result, n, side, crop_size):
    import torch

    check(tuple(result.images.shape) == (n, side, side, 3),
          f'images {tuple(result.images.shape)}')
    check(result.images.dtype == torch.uint8, 'images are not uint8')
    check(tuple(result.label_stack.shape) == (n, side, side, 4),
          f'labels {tuple(result.label_stack.shape)}')
    check(bool(torch.isfinite(result.label_stack).all()), 'labels not finite')
    check(tuple(result.active_masks.shape) == (n, side, side), 'active')
    check(int(result.active_masks.sum()) > 0, 'empty active masks')
    check(result.num_crops > 0, 'no crops')
    check(tuple(result.crop_images.shape)
          == (result.num_crops, crop_size, crop_size, 3), 'crop images')
    check(bool(torch.isfinite(result.crop_labels).all()), 'crops not finite')
    check(sum(len(w) for w in result.word_polygons) > 0, 'no text on pages')


def check_regions(regions, side: int = 640, crop_size: int = 320):
    """The text-region stream's output at RegionStreamConfig's default
    canvas (640) and crop size (320), kept on the device: stacked pages
    padded to a power-of-two count, labels, region crops."""
    import torch

    check(regions is not None, 'no text regions')
    m = regions.num_pages
    check(m >= 1, 'no stacked region page')
    m_pad = regions.images.shape[0]
    check(m_pad >= m and m_pad & (m_pad - 1) == 0 and m_pad < 2 * m + 1,
          f'{m_pad} stacked pages for num_pages {m}')
    check(isinstance(regions.images, torch.Tensor)
          and regions.images.dtype == torch.uint8
          and tuple(regions.images.shape) == (m_pad, side, side, 3),
          f'region pages {tuple(regions.images.shape)}')
    check(tuple(regions.active_masks.shape) == (m_pad, side, side)
          and int(regions.active_masks[:m].sum()) > 0,
          'region active masks')
    maps = regions.gaussian_maps
    check(tuple(maps.shape) == (m_pad, side, side)
          and bool(torch.isfinite(maps).all()) and float(maps.max()) > 0.3
          and float(maps.min()) >= 0.0, 'region gaussian maps')
    check(len(regions.region_boxes) == m and len(regions.regression) == m
          and sum(len(b) for b in regions.region_boxes) > 0
          and sum(len(p) for p in regions.char_polygons) > 0,
          'region labels')
    k = regions.num_crops
    check(k > 0 and tuple(regions.crop_images.shape)
          == (k, crop_size, crop_size, 3)
          and tuple(regions.crop_gaussians.shape) == (k, crop_size, crop_size)
          and tuple(regions.crop_active.shape) == (k, crop_size, crop_size)
          and int(regions.crop_page_ids.max()) < m, 'region crops')


def spread_plans(n: int, height: int, rng):
    """Split n two-page spreads (height x 1400) into deskewed height x 700
    pages: a small rotation about the half's center, then a crop of it."""
    from vkit_tpu_torch.host import matrix_plan

    plans = []
    cy = (height - 1) / 2
    for idx in range(n):
        theta = np.radians(rng.uniform(-1.5, 1.5))
        cx = 350.0 if idx % 2 == 0 else 1050.0
        cos, sin = np.cos(theta), np.sin(theta)
        mat = np.asarray([
            [cos, -sin, 349.5 - cos * cx + sin * cy],
            [sin, cos, cy - sin * cx - cos * cy],
            [0.0, 0.0, 1.0],
        ])
        plans.append(matrix_plan(mat, (height, 1400), (height, 700)))
    return plans


def sync(device):
    import torch

    if device.type == 'cuda':
        torch.cuda.synchronize()


def _label_planes(gen, shape):
    """Two 0/1 label planes (a mask and a score map) per sample."""
    return (gen.random(shape + (2,)) > 0.5).astype(np.float32)


def stream_rate(device, planner, seed: int, num_batches: int, regions: bool,
                side: int = 640, batch: int = 8):
    """synthesize_stream as bench config 6 calls it (with ``regions``; the
    earlier main path without): (pages/s with host prep, page crops,
    stacked region pages, region crops)."""
    from vkit_tpu_torch.synth import (
        CropConfig,
        RegionStreamConfig,
        synthesize_stream,
    )

    rng = np.random.default_rng(seed)
    crop_size = side * 4 // 5
    region_config = (RegionStreamConfig(num_crops_per_page=2) if regions
                     else None)
    sync(device)
    begin = time.perf_counter()
    pages = crops = stacked = region_crops = 0
    for result in synthesize_stream(
            planner, batch, 5, rng, num_batches=num_batches,
            crop_config=CropConfig(core_size=crop_size, num_per_page=2),
            region_config=region_config, keep_on_device=True,
            device=device):
        check_synth(result, batch, side, crop_size)
        pages += result.images.shape[0]
        crops += result.num_crops
        if regions:
            check_regions(result.text_regions)
            stacked += result.text_regions.num_pages
            region_crops += result.text_regions.num_crops
    sync(device)
    return (pages / (time.perf_counter() - begin), crops, stacked,
            region_crops)


def main_path(device, planner, seed: int, side: int = 640, batch: int = 8,
              distort_batch: int = 32, spread_height: int = 640):
    """One run of the main path; returns its rates."""
    import torch

    from vkit_tpu_torch.host import rescale_plan_to, sample_geometric_plans
    from vkit_tpu_torch.mechanism.batched import batched_plan_warp
    from vkit_tpu_torch.mechanism.batched_random import (
        batch_random_geometric_distort,
        batch_random_photometric_distort,
    )

    rates = {}
    (rates['synth_pages_per_s'], rates['synth_crops'],
     rates['region_pages'], rates['region_crops']) = stream_rate(
        device, planner, seed, num_batches=2, regions=True, side=side,
        batch=batch)

    # RandomDistortion, bench config 5's shape: photometric, then one warp
    # of image + labels onto the 704 x 704 canvas (timed on its own in
    # random_distortion_rate).
    gen = np.random.default_rng(seed + 1)
    shape = (distort_batch, side, side)
    images = torch.from_numpy(
        gen.integers(0, 256, shape + (3,), dtype=np.uint8)
    ).to(device)
    labels = torch.from_numpy(_label_planes(gen, shape)).to(device)
    out_shape = (704, 704)
    random_rng = np.random.default_rng(seed + 3)
    photo = batch_random_photometric_distort(images, 5, random_rng)
    check(photo.device.type == device.type and photo.dtype == torch.uint8,
          f'photometric stage output is {photo.dtype} on {photo.device}')
    plans = [rescale_plan_to(p, out_shape) for p in
             sample_geometric_plans(distort_batch, (side, side), 5,
                                    random_rng)]
    stack = torch.cat([photo.to(torch.float32), labels], dim=-1)
    warped = batched_plan_warp(plans, stack, mode='auto')[0]
    check(tuple(warped.shape) == (distort_batch,) + out_shape + (5,),
          f'RandomDistortion output {tuple(warped.shape)}')
    check(bool(torch.isfinite(warped).all()),
          'RandomDistortion output not finite')
    del photo, stack, warped, images

    stack = torch.cat([
        torch.from_numpy(
            gen.integers(0, 256, shape + (3,), dtype=np.uint8)
        ).to(device).to(torch.float32),
        labels,
    ], dim=-1)
    sync(device)
    begin = time.perf_counter()
    warped, active, boxes = batch_random_geometric_distort(
        stack, 5, np.random.default_rng(seed + 2), device=device
    )
    sync(device)
    rates['distort_images_per_s'] = (
        distort_batch / (time.perf_counter() - begin)
    )
    check(warped.shape[0] == distort_batch and warped.shape[3] == 5
          and tuple(warped.shape[1:3]) == active.shape[1:], 'distort shape')
    check(bool(torch.isfinite(warped).all()), 'distort output not finite')
    check(len(boxes) == distort_batch, 'distort boxes')
    del stack, warped, labels

    spreads = torch.from_numpy(gen.integers(
        0, 256, (batch, spread_height, 1400, 3), dtype=np.uint8
    )).to(device)
    plans = spread_plans(batch, spread_height, gen)
    sync(device)
    begin = time.perf_counter()
    pages_out, _, _ = batched_plan_warp(plans, spreads, border_value=255)
    sync(device)
    rates['spread_pages_per_s'] = batch / (time.perf_counter() - begin)
    check(tuple(pages_out.shape) == (batch, spread_height, 700, 3)
          and pages_out.dtype == torch.uint8, 'spread split output')
    return rates


def short_kernel_name(name: str) -> str:
    """A device operation's name without its template arguments: the
    kernel, and the functor it runs where the kernel is a generic one
    (``elementwise_kernel[direct_copy_kernel_cuda]``)."""
    words = re.findall(r'[A-Za-z_]\w*', name.replace('void ', '', 1))
    kernels = [w for w in words if 'kernel' in w or w.endswith('_impl')]
    if not kernels:
        return name[:60]
    inner = next((w for w in kernels[1:] if w != kernels[0]
                  and not w.startswith('gpu_kernel')), None)
    return kernels[0] + (f'[{inner}]' if inner else '')


# Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = frozenset({'kernel', 'gpu_memcpy', 'gpu_memset'})
# CUDA API calls that put work on the device: in a complete trace
# each has a device record of its correlation id.
DEVICE_WORK_CALL = re.compile(
    r'^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)')
# The device function each kernel wrapper launches (K4 runs K1's).
KERNEL_FUNCTIONS = {
    'row_shift_window_slab': 'row_shift_window_slab_kernel',
    'row_shift_window': 'row_shift_window_slab_kernel',
    'row_shift': 'row_shift_kernel',
    'banded_line_resample': 'banded_resample_kernel',
    'quadrant_slab': 'quadrant_slab_kernel',
    'line_blend': 'line_blend_kernel',
}


# Launches that open every traced session ahead of the measured call (a
# spin kernel each), left out of the reading: the profiler on the card has
# been seen to lose a session's first 18 device records, every other
# session, in runs that were otherwise alike.
TRACE_WARMUP_LAUNCHES = 64


def read_trace(log_dir, launches, top: int = 5,
               warmup: int = TRACE_WARMUP_LAUNCHES):
    """The one Chrome trace that device_trace wrote into ``log_dir``, less
    its first ``warmup`` launch calls and their device records (spin
    kernels): the device's busy time (the union of its kernel, copy and
    set intervals), the ``top`` longest idle gaps between them and device
    operations by summed time, and what the trace lacks (``missing``): the
    calls that put work on the device without a device record of their
    correlation id (with their places among the calls), and the kernel
    launches the counters saw (``launches``) without an event."""
    files = sorted(Path(log_dir).glob('*.json'))
    check(len(files) == 1, f'device_trace wrote {len(files)} files')
    with open(files[0]) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get('traceEvents', [])

    def correlation(e):
        return e.get('args', {}).get('correlation')

    events = [e for e in events if e.get('ph') == 'X' and 'ts' in e]
    calls = sorted((e for e in events
                    if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                    and DEVICE_WORK_CALL.match(e.get('name', ''))),
                   key=lambda e: correlation(e) or 0)
    warm = {correlation(e) for e in calls[:warmup]}
    calls = calls[warmup:]
    on_device = [e for e in events if e.get('cat') in DEVICE_CATEGORIES]
    missing = {}
    if any(('spin_kernel' in e.get('name', '')) != (correlation(e) in warm)
           for e in on_device):
        missing['the warm-up apart from the call'] = 1
    on_device = [e for e in on_device if correlation(e) not in warm]
    recorded = {correlation(e) for e in on_device}
    places = []
    for i, e in enumerate(calls):
        if correlation(e) not in recorded:
            missing[e['name']] = missing.get(e['name'], 0) + 1
            places.append(i)
    if places:
        missing['places (first, last, of)'] = (places[0], places[-1],
                                               len(calls))
    events_of = {}
    for name, count in launches.items():
        fn = KERNEL_FUNCTIONS[name]
        events_of[fn] = events_of.get(fn, 0) + count
    for fn, count in events_of.items():
        seen = sum(1 for e in on_device
                   if re.search(rf'\b{fn}\b', e.get('name', '')))
        if seen != count:
            missing[f'{fn} (launches, events)'] = (count, seen)
    intervals = sorted((float(e['ts']), float(e['ts']) + float(e.get('dur', 0)))
                       for e in on_device)
    busy, gaps, per_op = 0.0, [], {}
    for e in on_device:
        per_op[e['name']] = per_op.get(e['name'], 0.0) + float(e.get('dur', 0))
    cur_begin = cur_end = None
    for begin, end in intervals:
        if cur_end is None or begin > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_begin
                gaps.append(begin - cur_end)
            cur_begin, cur_end = begin, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_begin
    if not on_device:
        missing['any device operation'] = 0
    return {
        'busy_us': busy, 'gaps_us': sorted(gaps, reverse=True)[:top],
        'ops_us': sorted(per_op.items(), key=lambda kv: -kv[1])[:top],
        'missing': missing, 'trace_bytes': files[0].stat().st_size,
    }


def traced_runs(device, run, count: int, host: bool = True):
    """``run()`` ``count`` times, each under a device_trace of its own
    (opened by TRACE_WARMUP_LAUNCHES spin kernels) and between two CUDA
    events on the current stream: the device's clock of the call's window,
    from its first host step to its last device operation.
    A trace is complete when it lacks nothing (read_trace's ``missing``)
    and its busy time fits inside the events' window; only then does the
    reading get a ``busy_share`` (busy time over that window), else None.
    Returns the readings (with each run's wall seconds and events' ms) and
    the last run's result."""
    import tempfile

    import torch

    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.utility import device_trace

    readings, result = [], None
    for _ in range(count):
        sync(device)
        before = dict(K.LAUNCHES)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with tempfile.TemporaryDirectory() as log_dir:
            with device_trace(log_dir, host=host):
                for _ in range(TRACE_WARMUP_LAUNCHES):
                    torch.cuda._sleep(1000)
                sync(device)
                begin = time.perf_counter()
                start.record()
                result = run()
                end.record()
                sync(device)
                seconds = time.perf_counter() - begin  # before the export
            reading = read_trace(log_dir, {
                name: K.LAUNCHES[name] - before[name] for name in K.LAUNCHES})
        window_us = start.elapsed_time(end) * 1e3
        if reading['busy_us'] > window_us:
            reading['missing']['busy beyond the events\' window'] = 1
        reading.update(
            seconds=seconds, window_us=window_us,
            busy_share=(None if reading['missing']
                        else reading['busy_us'] / window_us))
        readings.append(reading)
    return readings, result


def log_traced(label, readings, card):
    """One line per traced run, and the spread of the complete ones'
    busy times; an incomplete trace's busy share is not measured."""
    for i, r in enumerate(readings, 1):
        state = (f'busy share {r["busy_share"]}' if r['busy_share'] is not None
                 else f'busy share not measured: trace incomplete, lacks '
                 f'{r["missing"]}')
        log(f'[{label} {i}/{len(readings)}] {r["seconds"]} s wall, device '
            f'busy {r["busy_us"] / 1e3} ms of a {r["window_us"] / 1e3} ms '
            f'window (CUDA events), {state}; longest idle gaps (ms) '
            f'{[round(g / 1e3, 3) for g in r["gaps_us"]]}; top device ops '
            f'(ms) ' + ', '.join(f'{short_kernel_name(op)} {us / 1e3:.3f}'
                                 for op, us in r['ops_us'])
            + f'; trace {r["trace_bytes"]} bytes | {card}')
    complete = [r for r in readings if r['busy_share'] is not None]
    busy = [r['busy_us'] / 1e3 for r in complete]
    shares = [r['busy_share'] for r in complete]
    log(f'[{label}] {len(complete)} of {len(readings)} traces complete'
        + (f': busy ms min {min(busy)} median {statistics.median(busy)} max '
           f'{max(busy)}, busy share min {min(shares)} median '
           f'{statistics.median(shares)} max {max(shares)}' if complete
           else ': busy share not measured') + f' | {card}')


def traced_synth_batches(device, planner, seed: int, side: int = 640,
                         batch: int = 8, count: int = 2):
    """synthesize_stream as phase 4 calls it (bench config 6), its first
    batch untraced and the next ``count`` each under device_trace without
    the host's operator events (some 1e5 small operators a batch).
    Returns traced_runs' readings."""
    from vkit_tpu_torch.synth import (
        CropConfig,
        RegionStreamConfig,
        synthesize_stream,
    )

    crop_size = side * 4 // 5
    stream = synthesize_stream(
        planner, batch, 5, np.random.default_rng(seed),
        num_batches=1 + count,
        crop_config=CropConfig(core_size=crop_size, num_per_page=2),
        region_config=RegionStreamConfig(num_crops_per_page=2),
        keep_on_device=True, device=device)
    check_synth(next(stream), batch, side, crop_size)

    def next_batch():
        out = next(stream)
        check_synth(out, batch, side, crop_size)
        return out

    readings, _ = traced_runs(device, next_batch, count, host=False)
    stream.close()
    return readings


def _label_sample(side: int):
    """64 box polygons and 64 points on an 8 x 8 grid of the page."""
    cell = side // 8
    polygons, points = [], []
    for row in range(8):
        for col in range(8):
            up, left = row * cell + 4, col * cell + 4
            polygons.append(np.asarray([
                (left, up), (left + cell - 8, up),
                (left + cell - 8, up + cell // 2), (left, up + cell // 2),
            ], dtype=np.float64))
            points.append((left, up))
    return polygons, np.asarray(points, dtype=np.float64)


def random_distortion_rate(device, seed: int, side: int = 640,
                           batch: int = 32, warmups: int = 8,
                           iters: int = 6):
    """RandomDistortion images/s at bench config 5's step: the photometric
    stage, geometric plans rescaled to the 704 x 704 canvas, one warp of
    image + mask + score map, the polygon / point co-transform and the
    content boxes; each step waits for the previous step's output, as
    bench.py's loop does.  Returns (images/s, per-step seconds)."""
    import torch

    from vkit_tpu_torch.host import (
        plan_content_box,
        rescale_plan_to,
        sample_geometric_plans,
    )
    from vkit_tpu_torch.mechanism.batched import batched_plan_warp
    from vkit_tpu_torch.mechanism.batched_random import (
        batch_random_photometric_distort,
    )

    gen = np.random.default_rng(seed)
    images = torch.from_numpy(
        gen.integers(0, 256, (batch, side, side, 3), dtype=np.uint8)
    ).to(device)
    labels = np.empty((batch, side, side, 2), dtype=np.float32)
    labels[..., 0] = 1.0
    labels[..., 1] = gen.random((batch, side, side), dtype=np.float32)
    labels = torch.from_numpy(labels).to(device)
    polygons, points = _label_sample(side)
    all_xy = np.concatenate(polygons + [points], axis=0)
    out_shape = (704, 704)
    pending = [None]

    def step():
        photo = batch_random_photometric_distort(images, 5, gen)
        plans = [rescale_plan_to(p, out_shape) for p in
                 sample_geometric_plans(batch, (side, side), 5, gen)]
        stack = torch.cat([photo.to(torch.float32), labels], dim=-1)
        out = batched_plan_warp(plans, stack, mode='auto')[0]
        for plan in plans:
            plan.map_points(all_xy)
            plan_content_box(plan)
        if pending[0] is not None:
            float(pending[0][:, ::64, ::64, 0].mean())
        pending[0] = out

    for _ in range(warmups):
        step()
    sync(device)
    times = []
    begin = time.perf_counter()
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    sync(device)
    seconds = time.perf_counter() - begin
    out = pending[0]
    check(tuple(out.shape) == (batch,) + out_shape + (5,),
          f'RandomDistortion output {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()),
          'RandomDistortion output not finite')
    return iters * batch / seconds, times


def stage_spans(device, planner, seed: int, side: int = 640,
                batches: int = 2, batch: int = 8):
    """Per-stage seconds of synthesize_page_batch (its own timer spans,
    each closed by a device synchronize) over 8-page 640 x 640 batches,
    level 5, two 512 x 512 crops per page, char gaussian maps and the
    text-region stream on, after one batch untimed.  Returns {stage: mean
    seconds per batch}, the text regions' sub-spans included (they are part
    of ``region``), and the mean regions per batch."""
    from vkit_tpu_torch.host import StepTimer
    from vkit_tpu_torch.synth import (
        CropConfig,
        RegionStreamConfig,
        synthesize_page_batch,
    )

    rng = np.random.default_rng(seed)
    crop_size = side * 4 // 5
    crop = CropConfig(core_size=crop_size, num_per_page=2)
    page_sets = [planner.prepare_batch(batch, rng)
                 for _ in range(batches + 1)]
    timer = StepTimer()
    region_count = 0
    for idx, pages in enumerate(page_sets):
        result = synthesize_page_batch(
            pages, 5, rng, crop_config=crop, emit_char_gaussians=True,
            region_config=RegionStreamConfig(num_crops_per_page=2),
            keep_on_device=True, device=device,
            timer=timer if idx else None,
        )
        check_synth(result, batch, side, crop_size)
        check_regions(result.text_regions)
        maps = result.char_gaussian_maps
        check(tuple(maps.shape) == (batch, side, side)
              and float(maps.max()) > 0.3, 'char gaussian maps')
        if idx:
            region_count += sum(len(b) for b in
                                result.text_regions.region_boxes)
    for name in ('photometric', 'char-gaussians', 'region',
                 'region.collect-host', 'region.gaussians',
                 'region.regression-host'):
        check(timer.counts[name] == batches, f'the {name} span did not run')
    # The region stream gathers, flattens and composites a chunk at a time.
    chunks = timer.counts['region.gather+flatten']
    check(chunks >= batches, 'the region.gather+flatten span did not run')
    check(timer.counts['region.composite'] == chunks,
          f'{timer.counts["region.composite"]} region.composite spans for '
          f'{chunks} flattened chunks')
    return ({name: timer.totals[name] / batches for name in timer.totals},
            region_count / batches)


def small_batch_agreement(device, planner):
    """A 320x320 batch with the photometric stage off, through the kernels
    on the card and through the plain versions on the CPU: same masks,
    images within 1 LSB and labels within 1e-2 inside the active masks."""
    from vkit_tpu_torch.synth import CropConfig, synthesize_page_batch

    pages = planner.prepare_batch(2, np.random.default_rng(21))
    crop = CropConfig(core_size=192, num_per_page=2)
    card = synthesize_page_batch(pages, 5, np.random.default_rng(22),
                                 enable_photometric=False,
                                 crop_config=crop, device=device)
    host = synthesize_page_batch(pages, 5, np.random.default_rng(22),
                                 enable_photometric=False,
                                 crop_config=crop, device='cpu')
    check(np.array_equal(card.active_masks, host.active_masks),
          'active masks differ between card and CPU')
    act = card.active_masks > 0
    img_err = int(np.abs(card.images.astype(int)
                         - host.images.astype(int))[act].max())
    lab_err = float(np.abs(card.label_stack - host.label_stack)[act].max())
    check(img_err <= 1, f'card vs CPU images differ by {img_err} LSB')
    check(lab_err <= 1e-2, f'card vs CPU labels differ by {lab_err}')
    check(np.array_equal(card.crop_windows, host.crop_windows),
          'crop windows differ between card and CPU')
    return img_err, lab_err


def region_agreement(device, planner):
    """The same 320x320 batch with the text-region stream on, on the card
    and on the CPU: the host fields equal; stacked pages within 1 LSB,
    coverage equal and gaussian maps within 1e-4 but for a share of
    REGION_EDGE_SHARE of the pixels (outline pixels where a float32
    threshold flips).  Returns the shares that differed."""
    from vkit_tpu_torch.synth import RegionStreamConfig, synthesize_page_batch

    pages = planner.prepare_batch(2, np.random.default_rng(25))
    config = RegionStreamConfig(page_size=320, target_char_height=24,
                                num_crops_per_page=1, crop_size=160)
    card, host = (
        synthesize_page_batch(pages, 5, np.random.default_rng(26),
                              enable_photometric=False, region_config=config,
                              device=dev).text_regions
        for dev in (device, 'cpu'))
    check(card is not None and host is not None, 'no text regions at 320')
    check(card.num_pages == host.num_pages >= 1
          and card.num_crops == host.num_crops, 'region page / crop counts')

    def boxes(per_page):
        return [[(b.up, b.down, b.left, b.right) for b in page]
                for page in per_page]

    check(boxes(card.region_boxes) == boxes(host.region_boxes),
          'region boxes differ between card and CPU')
    check(all(np.array_equal(a.to_np_array(), b.to_np_array())
              for pa, pb in zip(card.char_polygons, host.char_polygons)
              for a, b in zip(pa, pb)), 'region char polygons differ')
    check(all(np.array_equal(getattr(a, f), getattr(b, f))
              for a, b in zip(card.regression, host.regression)
              for f in a._fields), 'region regression labels differ')
    check(np.array_equal(card.crop_page_ids, host.crop_page_ids),
          'region crop ids differ')
    img = (np.abs(card.images.astype(int) - host.images.astype(int))
           .max(axis=-1) > 1).mean()
    act = (card.active_masks != host.active_masks).mean()
    maps = (np.abs(card.gaussian_maps - host.gaussian_maps) > 1e-4).mean()
    crop = (np.abs(card.crop_images.astype(int)
                   - host.crop_images.astype(int)).max(axis=-1) > 1).mean()
    for what, share in (('pages', img), ('coverage', act),
                        ('gaussian maps', maps), ('crops', crop)):
        check(share <= REGION_EDGE_SHARE,
              f'card vs CPU region {what}: {share} of the pixels differ')
    return {'pages': float(img), 'coverage': float(act),
            'gaussian_maps': float(maps), 'crops': float(crop)}


def deterministic_stage():
    """The photometric stage config without its rng-consuming ops."""
    import attr

    from vkit_tpu_torch.host import random_distortion_factory
    from vkit_tpu_torch.mechanism.batched import RNG_CONSUMING

    stage = random_distortion_factory.create_photometric_stage_config()
    keep = [i for i, p in enumerate(stage.distortion_policies)
            if p.name not in RNG_CONSUMING]
    return attr.evolve(
        stage,
        distortion_policies=[stage.distortion_policies[i] for i in keep],
        distortion_policy_weights=[stage.distortion_policy_weights[i]
                                   for i in keep],
    )


def check_images_close(names, got, want, what):
    """uint8 ``got`` against ``want`` at the tolerance of the ops in
    ``names``; returns the max abs difference."""
    diff = np.abs(got.astype(int) - want.astype(int))
    err = int(diff.max()) if diff.size else 0
    if set(names) & HSV_ROUNDING:
        # One HSV / HSL rounding boundary moves a pixel by up to 8 LSB; a
        # later op of the same draw (posterization) can widen the step.
        limit = 8 if len(names) == 1 else 255
        check(err <= limit and diff.mean() < 0.5
              and (len(names) == 1 or (diff > 1).mean() < 1e-3),
              f'{what}: {names} differ by {err} LSB (mean {diff.mean()})')
    else:
        check(err <= 1, f'{what}: {names} differ by {err} LSB')
    return err


def photometric_agreement(device, planner):
    """The photometric stage restricted to its deterministic ops, on the
    backgrounds of 8 320x320 pages, on the card and on the CPU."""
    import torch

    from vkit_tpu_torch.mechanism.batched_random import (
        batch_random_photometric_distort,
        sample_photometric_sequences,
    )

    stage = deterministic_stage()
    pages = planner.prepare_batch(8, np.random.default_rng(23))
    images = torch.from_numpy(np.stack([p.background for p in pages]))
    _, draws = sample_photometric_sequences(
        8, images.shape[1:3], 5, np.random.default_rng(24), stage)
    card = batch_random_photometric_distort(
        images.to(device), 5, np.random.default_rng(24), stage_config=stage)
    host = batch_random_photometric_distort(
        images, 5, np.random.default_rng(24), stage_config=stage)
    check(card.device.type == device.type,
          f'photometric output is on {card.device}')
    card, host = card.cpu().numpy(), host.numpy()
    check(any(draws), 'no sample drew a photometric op')
    return max(check_images_close([n for n, _ in seq], c, h, 'card vs CPU')
               for c, h, seq in zip(card, host, draws))


def _catalog_configs(policy, static_signature, n, shape, rng):
    """Policy-sampled level-5 configs that can share one batched apply."""
    configs = [policy.sample_config(5, shape, rng) for _ in range(n)]
    sig0 = static_signature(policy.name, configs[0])
    configs = [c if static_signature(policy.name, c) == sig0 else configs[0]
               for c in configs]
    if policy.name in ('pixelation', 'zoom_in_blur'):
        configs = [configs[0]] * n
    return configs


def check_rng_op(name, out, images, configs, blurred=None):
    """Moments of an rng-consuming op on each member against its config."""
    def mean_ok(values, spread):
        # Within five standard errors of zero.
        return abs(values.mean()) <= 5 * spread / np.sqrt(values.size)

    for o, img, cfg in zip(out.astype(np.float64), images.astype(np.float64),
                           configs):
        delta = o - img
        if name == 'gaussion_noise':
            sigma = float(cfg.std)
            inside = (img >= 4 * sigma) & (img <= 255 - 4 * sigma)
            expect = np.sqrt(sigma * sigma + 1 / 12)
            check(mean_ok(delta[inside], expect)
                  and abs(delta[inside].std() - expect) <= 0.05 * expect,
                  f'{name}: moments {delta[inside].mean()}, '
                  f'{delta[inside].std()} for std {sigma}')
        elif name == 'speckle_noise':
            sigma = float(cfg.std)
            inside = (img >= 64) & (img * (1 + 4 * sigma) <= 255)
            rel = delta[inside] / img[inside]
            check(inside.sum() > 1000 and mean_ok(rel, sigma + 0.01)
                  and abs(rel.std() - sigma) <= 0.1 * sigma + 0.01,
                  f'{name}: relative moments {rel.mean()}, {rel.std()} '
                  f'for std {sigma}')
        elif name == 'poisson_noise':
            inside = (img >= 20) & (img <= 200)
            check(mean_ok(delta[inside], np.sqrt(img[inside].mean()))
                  and abs(delta[inside].var() / img[inside].mean() - 1)
                  <= 0.05,
                  f'{name}: mean {delta[inside].mean()}, var '
                  f'{delta[inside].var()} for mean lambda '
                  f'{img[inside].mean()}')
        elif name == 'impulse_noise':
            for value, base, prob in ((255, img < 255, cfg.prob_salt),
                                      (0, img > 0, cfg.prob_pepper)):
                frac = np.mean(o[base] == value)
                tol = 5 * np.sqrt(max(prob, 1e-4) / base.sum()) + 1e-3
                check(abs(frac - prob) <= tol,
                      f'{name}: fraction {frac} of {value} for p {prob}')
        elif name == 'channel_permutation':
            picks = sorted(
                next((i for i in range(3)
                      if np.array_equal(o[..., c], img[..., i])), -1)
                for c in range(3)
            )
            check(picks == [0, 1, 2], f'{name}: channels {picks}')
        elif name == 'fog':
            fog = np.broadcast_to(np.asarray(cfg.fog_rgb, np.float64),
                                  img.shape)
            inside = ((o >= np.minimum(img, fog) - 1)
                      & (o <= np.maximum(img, fog) + 1))
            far = np.abs(fog - img) > 32
            ratio = (o - img)[far] / (fog - img)[far]
            check(inside.all() and ratio.std() > 0.01,
                  f'{name}: not a blend toward the fog color')
    if name == 'glass_blur':
        # Swaps only permute pixels of the blurred image.
        for o, b in zip(out, blurred):
            check(np.array_equal(np.sort(o, axis=None), np.sort(b, axis=None)),
                  f'{name}: output is not a permutation of the blur')


def catalog_phase(device, side: int = 640):
    """Every catalog name once on the card (6 of 8 samples members), then
    one mixed round of the one-program catalog.  Returns per-name seconds
    and max abs errors against the CPU (None for rng-consuming names)."""
    import torch

    from vkit_tpu_torch.host import (
        random_distortion_factory,
        static_signature,
    )
    from vkit_tpu_torch.mechanism import batched as B
    from vkit_tpu_torch.mechanism.photometric_program import (
        MEGA_NAMES,
        apply_mega_round,
    )
    from vkit_tpu_torch.ops.blur import filter2d

    stage = random_distortion_factory.create_photometric_stage_config()
    policies = {p.name: p for p in stage.distortion_policies}
    check(set(policies) == set(B._CATALOG),
          f'catalog names {sorted(set(policies) ^ set(B._CATALOG))} differ')
    n, members = 8, 6
    gen = np.random.default_rng(5)
    # Smooth page-like content in [40, 215], so noise moments are not
    # clipped at 0 / 255.
    coarse = gen.integers(40, 216, (n, 10, 10, 3)).astype(np.float32)
    up = np.kron(coarse, np.ones((1, side // 10, side // 10, 1), np.float32))
    images_np = np.clip(up + gen.normal(0, 6, up.shape), 40, 215).astype(
        np.uint8)
    images = torch.from_numpy(images_np).to(device)
    rng = np.random.default_rng(6)
    results = {}
    for name in sorted(policies):
        configs = _catalog_configs(policies[name], static_signature, n,
                                   (side, side), rng)
        group = list(enumerate(configs[:members]))
        sync(device)
        begin = time.perf_counter()
        out = B.batch_distort_members(name, group, images, 17)
        sync(device)
        seconds = time.perf_counter() - begin
        check(out.device.type == device.type and out.dtype == torch.uint8
              and tuple(out.shape) == (n, side, side, 3),
              f'{name}: output {out.device} {out.dtype} {tuple(out.shape)}')
        check(torch.equal(out[members:], images[members:]),
              f'{name}: a non-member changed')
        out_np = out.cpu().numpy()
        err = None
        if name in B.RNG_CONSUMING:
            blurred = None
            if name == 'glass_blur':
                kernels = B._prep_kernels('gaussian_blur', configs[:members],
                                          (members, side, side, 3))
                blurred = filter2d(images[:members], kernels).cpu().numpy()
            check_rng_op(name, out_np[:members], images_np[:members],
                         configs[:members], blurred)
        else:
            host = B.batch_distort_members(name, group,
                                           torch.from_numpy(images_np), 17)
            err = check_images_close([name], out_np, host.numpy(),
                                     'card vs CPU')
        results[name] = {'seconds': seconds, 'max_abs_err': err}

    # One round of the one-program catalog: a different op per sample,
    # the last sample passing through.
    names = ['mean_shift', 'brightness_shift', 'complement', 'posterization',
             'gaussian_blur', 'line_streak', 'gaussion_noise']
    check(set(names) <= set(MEGA_NAMES), 'mega names drifted')
    round_members = {
        name: [(i, policies[name].sample_config(5, (side, side), rng))]
        for i, name in enumerate(names)
    }
    sync(device)
    begin = time.perf_counter()
    card = apply_mega_round(images, round_members, 29)
    sync(device)
    mega_seconds = time.perf_counter() - begin
    check(card.device.type == device.type and card.dtype == torch.uint8,
          f'mega round output {card.dtype} on {card.device}')
    host = apply_mega_round(torch.from_numpy(images_np), round_members,
                            29).numpy()
    card = card.cpu().numpy()
    check(np.array_equal(card[n - 1], images_np[n - 1]),
          'mega round changed its passthrough sample')
    mega_err = 0
    for i, name in enumerate(names):
        if name in B.RNG_CONSUMING:
            check_rng_op(name, card[i:i + 1], images_np[i:i + 1],
                         [round_members[name][0][1]])
            continue
        mega_err = max(mega_err, check_images_close(
            [name], card[i], host[i], 'mega round card vs CPU'))
    results['mega_round'] = {'seconds': mega_seconds, 'max_abs_err': mega_err}
    return results


# ---------------------------------------------------------------------------
# Phase 6: the training path, the one-program chain, the dense two-pass.
# ---------------------------------------------------------------------------

NARROW_NET = dict(stage_features=(32, 64), fpn_features=32)
# batched_plan_warp(mode='dense') against mode='gather' on a smooth image
# (tests/test_torch_dense_warp.py states the same): mean LSB inside the
# active mask eroded by 4 px, max LSB inside it eroded by one 16-px node
# cell.  The two-pass filters with a sheared footprint, and the gather
# reads node-interpolated positions.
DENSE_VS_GATHER_MEAN = 0.5
DENSE_VS_GATHER_MAX = 8.0


def training_path(device, planner, seed: int, side: int = 640,
                  batch: int = 8, timed_steps: int = 4):
    """synthesize_stream as bench config 6 calls it, char gaussian maps on,
    kept on the device -> synth_to_train_batch -> train steps of the default
    TextDetectionNet (64-128-256-512, FPN 128, bfloat16): one warm-up step
    and ``timed_steps`` timed ones on fresh batches, then ``timed_steps``
    on the last batch repeated.  Returns the trained state and the
    readings."""
    import torch

    from vkit_tpu_torch.models import (
        create_model,
        create_optimizer,
        init_train_state,
        make_train_step,
        synth_to_train_batch,
    )
    from vkit_tpu_torch.synth import (
        CropConfig,
        RegionStreamConfig,
        synthesize_stream,
    )

    model = create_model()
    check(model.stage_features == (64, 128, 256, 512)
          and model.fpn_features == 128 and model.dtype == torch.bfloat16,
          'the default detector is not the full-width bfloat16 net')
    optimizer = create_optimizer(1e-3)
    train_step = make_train_step(model, optimizer)
    crop_size = side * 4 // 5
    torch.cuda.reset_peak_memory_stats()
    state = train_batch = None
    losses, loop_step_seconds = [], []
    sync(device)
    # From the first request on: the stream prepares batches ahead while a
    # step runs, so a window that opens later would count batches it did
    # not produce.
    loop_begin = time.perf_counter()
    for idx, result in enumerate(synthesize_stream(
            planner, batch, 5, np.random.default_rng(seed),
            num_batches=1 + timed_steps,
            crop_config=CropConfig(core_size=crop_size, num_per_page=2),
            emit_char_gaussians=True,
            region_config=RegionStreamConfig(num_crops_per_page=2),
            keep_on_device=True, device=device)):
        check_synth(result, batch, side, crop_size)
        check_regions(result.text_regions)
        train_batch = synth_to_train_batch(
            result.images, result.label_stack, result.active_masks,
            char_gaussians=result.char_gaussian_maps)
        check(all(field.device.type == 'cuda' for field in train_batch),
              'the train batch left the card')
        check(tuple(train_batch.char_masks.shape)
              == (batch, side // 2, side // 2)
              and float(train_batch.char_masks.sum()) > 0
              and float(train_batch.char_gaussians.max()) > 0.3,
              'the label bridge made empty targets')
        if state is None:
            state = init_train_state(model, optimizer, train_batch.images,
                                     seed=0, device=device)
        sync(device)
        begin = time.perf_counter()
        state, metrics = train_step(state, train_batch)
        sync(device)
        loop_step_seconds.append(time.perf_counter() - begin)
        losses.append(float(metrics['loss']))
    loop_seconds = time.perf_counter() - loop_begin
    check(len(losses) == 1 + timed_steps, f'{len(losses)} train steps ran')

    # The step alone: the same batch again, and its own peak memory (the
    # phase's peak above includes the stream's region flatten).
    phase_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    repeat_losses, alone_seconds = [], []
    for _ in range(timed_steps):
        sync(device)
        begin = time.perf_counter()
        state, metrics = train_step(state, train_batch)
        sync(device)
        alone_seconds.append(time.perf_counter() - begin)
        repeat_losses.append(float(metrics['loss']))
    step_peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses + repeat_losses)),
          f'a loss is not finite: {losses} {repeat_losses}')
    check(repeat_losses[-1] < repeat_losses[0],
          f'the loss on a repeated batch did not fall: {repeat_losses}')
    check(int(state.step) == 1 + 2 * timed_steps, f'step {int(state.step)}')
    check(all(p.device.type == 'cuda' and p.dtype == torch.float32
              for p in state.params.values()),
          'parameters are not float32 on the card')
    with torch.no_grad():
        outputs = torch.func.functional_call(
            model, state.params, (train_batch.images,))
    check(all(tuple(o.shape) == (batch, side // 2, side // 2, 1)
              and o.dtype == torch.float32
              and bool(torch.isfinite(o).all()) for o in outputs),
          f'detector outputs {[tuple(o.shape) for o in outputs]}')
    return state, {
        'pages_per_s': (1 + timed_steps) * batch / loop_seconds,
        'warmup_step_seconds': loop_step_seconds[0],
        'loop_step_seconds': loop_step_seconds[1:],
        'alone_step_seconds': alone_seconds,
        'losses': losses, 'repeat_losses': repeat_losses,
        'peak_bytes': phase_peak,
        'step_peak_bytes': step_peak,
        'parameters': sum(p.numel() for p in state.params.values()),
    }


def detector_agreement(device, side: int = 128):
    """One forward of the narrow net in float32 on the card and on the CPU
    from the same state: max abs difference of the three outputs."""
    import torch

    from vkit_tpu_torch.models import (
        create_model,
        create_optimizer,
        init_train_state,
    )

    images = torch.from_numpy(np.random.default_rng(31).integers(
        0, 256, (2, side, side, 3), dtype=np.uint8))
    model = create_model(dtype=torch.float32, **NARROW_NET)
    state = init_train_state(model, create_optimizer(), images, seed=1,
                             device=device)
    host = create_model(dtype=torch.float32, **NARROW_NET)
    host.load_state_dict({k: v.cpu() for k, v in state.params.items()})
    with torch.no_grad():
        card_out = model(images.to(device))
        host_out = host(images)
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(card_out, host_out))
    check(err <= 1e-3, f'detector card vs CPU differ by {err}')
    return err


def checkpoint_round_trip(state):
    """CheckpointManager.save from the card and restore onto it: equal
    tensors, step and metadata."""
    import shutil

    import torch

    from vkit_tpu_torch.models import CheckpointManager

    root = REPO / 'build' / 'chip_smoke_checkpoints'
    shutil.rmtree(root, ignore_errors=True)
    manager = CheckpointManager(root)
    begin = time.perf_counter()
    manager.save(state, metadata={'pages_seen': 72})
    restored = manager.restore(state)
    seconds = time.perf_counter() - begin
    check(manager.latest_step() == int(state.step) == int(restored.step),
          'checkpoint step')
    check(manager.read_metadata() == {'step': int(state.step),
                                      'pages_seen': 72},
          f'checkpoint metadata {manager.read_metadata()}')
    check(restored.step.device.type == 'cuda'
          and restored.params.keys() == state.params.keys()
          and all(v.device.type == 'cuda' and torch.equal(v, state.params[k])
                  for k, v in restored.params.items()),
          'restored parameters differ')
    saved, loaded = state.opt_state['state'], restored.opt_state['state']
    check(saved.keys() == loaded.keys() and len(saved) == len(state.params)
          and all(torch.equal(loaded[k][name], value)
                  and loaded[k][name].device == value.device
                  for k, entry in saved.items()
                  for name, value in entry.items()),
          'restored optimizer state differs')
    size = sum(f.stat().st_size for f in root.rglob('*') if f.is_file())
    shutil.rmtree(root, ignore_errors=True)
    return seconds, size


def prefetch_check(device, batches: int = 4):
    """parallel.prefetch_map moves host batches onto the card (pinned
    memory, a side stream) in order."""
    import torch

    from vkit_tpu_torch.parallel import prefetch_map

    def produce(idx):
        return {'images': np.full((8, 64, 64, 3), idx, np.uint8),
                'index': idx}

    seen = list(prefetch_map(produce, batches, device=device))
    check([b['index'] for b in seen] == list(range(batches))
          and all(isinstance(b['images'], torch.Tensor)
                  and b['images'].device.type == 'cuda'
                  and int(b['images'].max()) == int(b['images'].min()) == i
                  for i, b in enumerate(seen)),
          'prefetch_map lost the order or the device')


def chain_inputs(device, seed: int, side: int = 640, batch: int = 64):
    """parallel.synthesize_batch's arguments at bench config 1's shape
    (batch 64 of 640 x 640 x 3 uint8, level 5, resized to 640 x 640), on
    the card; ``chain()`` calls it once on them."""
    import torch

    from vkit_tpu_torch import convert
    from vkit_tpu_torch.parallel import (
        sample_synthesis_params,
        synthesize_batch,
    )

    gen = np.random.default_rng(seed)
    images = torch.from_numpy(
        gen.integers(0, 256, (batch, side, side, 3), dtype=np.uint8)
    ).to(device)
    params, statics = sample_synthesis_params(gen, batch, side, side, level=5)
    params = convert.synthesis_params(params, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def chain():
        return synthesize_batch(images, params, generator, statics,
                                out_shape=(side, side))

    return images, chain


def chain_path(device, images, chain, warmups: int = 2, steps: int = 5):
    """The chain on chain_inputs(): images/s over a plain loop closed by
    one synchronize, after ``warmups`` calls."""
    import torch

    batch, side = images.shape[:2]
    out = None
    for _ in range(warmups):
        out = chain()
    sync(device)
    begin = time.perf_counter()
    for _ in range(steps):
        out = chain()
    sync(device)
    seconds = time.perf_counter() - begin
    check(tuple(out.shape) == (batch, side, side, 3)
          and out.dtype == torch.uint8 and out.device.type == 'cuda',
          f'chain output {tuple(out.shape)} {out.dtype} on {out.device}')
    check(not torch.equal(out, images) and float(out.float().std()) > 1.0,
          'the chain changed nothing')
    return steps * batch / seconds


def chain_agreement(device, side: int = 320, batch: int = 4):
    """The chain with noise off on the card and on the CPU (JPEG on for
    every other sample, resized to 256 x 256): max LSB apart."""
    import torch

    from vkit_tpu_torch.parallel import (
        sample_synthesis_params,
        synthesize_batch,
    )

    gen = np.random.default_rng(41)
    images = torch.from_numpy(
        gen.integers(0, 256, (batch, side, side, 3), dtype=np.uint8))
    params, statics = sample_synthesis_params(gen, batch, side, side, level=5)
    params = params._replace(
        noise_stds=np.zeros(batch, np.float32),
        jpeg_enables=(np.arange(batch) % 2 == 0).astype(np.float32))
    outs = []
    for dev in (device, torch.device('cpu')):
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        outs.append(synthesize_batch(images.to(dev), params, generator,
                                     statics, out_shape=(256, 256)).cpu())
    err = int((outs[0].int() - outs[1].int()).abs().max())
    check(err <= 1, f'chain card vs CPU differ by {err} LSB')
    return err


def _mild_camera_plan(rng, side: int):
    from vkit_tpu_torch.mechanism import distortion

    axis = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]][int(rng.integers(0, 2))]
    config = {
        'curve_alpha': float(rng.uniform(-1.5, 1.5)),
        'curve_beta': float(rng.uniform(-1.5, 1.5)),
        'curve_direction': float(rng.uniform(0, 45)),
        'curve_scale': 1.0,
        'camera_model_config': {
            'rotation_unit_vec': axis,
            'rotation_theta': float(rng.uniform(-1.0, 1.0)),
        },
        'grid_size': 32,
    }
    return distortion.camera_cubic_curve.plan(config, (side, side), rng)


DENSE_CANVAS = (672, 672)
# Phase 3 builds the chain's and the dense warp's inputs from these seeds to
# check their kernel launches, phase 6 builds them again for the counted runs.
CHAIN_SEED = 600
DENSE_SEED = 700


def dense_inputs(device, seed: int, side: int = 640, batch: int = 8):
    """batched_plan_warp(mode='dense')'s arguments: ``batch`` x 640 x 640 x
    5 float32 (a smooth image and two label planes) and mild camera plans.
    The dense mode sends a whole batch to the gather when one sample's
    field needs more than 24 taps, so each drawn plan is first tried alone
    (on a fixed canvas a sample's route does not depend on its neighbours)
    and kept if the two-pass took it.  Returns (stack as numpy, stack on
    the card, the kept plans, how many were drawn)."""
    import torch
    from scipy.ndimage import gaussian_filter

    from vkit_tpu_torch.mechanism.batched import batched_plan_warp
    from vkit_tpu_torch.ops import kernels as K

    gen = np.random.default_rng(seed)
    stack_np = gaussian_filter(
        gen.random((batch, side, side, 5)) * 255, sigma=(0, 2, 2, 0)
    ).astype(np.float32)
    stack = torch.from_numpy(stack_np).to(device)

    def shifts():
        return K.LAUNCHES['row_shift_window_slab'] + K.LAUNCHES['row_shift']

    plans, drawn = [], 0
    while len(plans) < batch:
        check(drawn < 20 * batch, f'only {len(plans)} of {drawn} mild camera '
              'plans took the dense two-pass')
        plan = _mild_camera_plan(gen, side)
        drawn += 1
        before = shifts()
        batched_plan_warp([plan], stack[:1], mode='dense',
                          canvas_shape=DENSE_CANVAS)
        if shifts() > before:
            plans.append(plan)
    return stack_np, stack, plans, drawn


def dense_path(device, stack_np, stack, plans, drawn):
    """The counted run of batched_plan_warp(mode='dense') on
    dense_inputs(): it is held to mode='gather' inside the active masks and
    to its own run on the CPU (two samples).  Returns the readings."""
    import torch
    from scipy.ndimage import binary_erosion

    from vkit_tpu_torch.host import warp_active_mask
    from vkit_tpu_torch.mechanism.batched import batched_plan_warp
    from vkit_tpu_torch.ops import kernels as K

    batch, side = stack.shape[:2]
    canvas = DENSE_CANVAS
    sync(device)
    K.reset_launch_counts()
    begin = time.perf_counter()
    dense, shapes, _ = batched_plan_warp(plans, stack, mode='dense',
                                         border_value=0.0,
                                         canvas_shape=canvas)
    sync(device)
    seconds = time.perf_counter() - begin
    launches = dict(K.LAUNCHES)
    check(launches['row_shift_window_slab'] + launches['row_shift'] == 2,
          f'the dense batch did not take the two-pass: {launches}')
    check(tuple(dense.shape) == (batch,) + tuple(canvas) + (5,)
          and dense.dtype == torch.float32
          and bool(torch.isfinite(dense).all()),
          f'dense output {tuple(dense.shape)} {dense.dtype}')
    gather = batched_plan_warp(plans, stack, mode='gather',
                               canvas_shape=canvas)[0]
    diff = (dense - gather).abs().amax(dim=-1).cpu().numpy()
    mean_err = max_err = 0.0
    for i, plan in enumerate(plans):
        h, w = shapes[i]
        active = warp_active_mask(plan).mat.astype(bool)
        near = binary_erosion(active, iterations=4)
        core = binary_erosion(active, iterations=16)
        check(core.sum() > side * side // 2, 'the active mask is small')
        mean_err = max(mean_err, float(diff[i, :h, :w][near].mean()))
        max_err = max(max_err, float(diff[i, :h, :w][core].max()))
    check(mean_err <= DENSE_VS_GATHER_MEAN and max_err <= DENSE_VS_GATHER_MAX,
          f'dense vs gather: mean {mean_err}, max {max_err} LSB')
    host = batched_plan_warp(plans[:2], torch.from_numpy(stack_np[:2]),
                             mode='dense', canvas_shape=canvas)[0]
    host_err = float((dense[:2].cpu() - host).abs().max())
    check(host_err <= 1e-3, f'dense card vs CPU differ by {host_err}')
    return {'seconds': seconds, 'launches': launches, 'drawn': drawn,
            'mean_vs_gather': mean_err, 'max_vs_gather': max_err,
            'card_vs_cpu': host_err}


# ---------------------------------------------------------------------------
# Phase 7: the multi-device path.
# ---------------------------------------------------------------------------


def multidevice_path(side: int = 640, pages_per_rank: int = 8):
    """entry.dryrun_multichip on this card, in one NCCL process group of
    world size 1 that meets through a FileStore; returns its report."""
    import torch.distributed as dist

    from vkit_tpu_torch.entry import dryrun_multichip
    from vkit_tpu_torch.parallel import initialize_distributed

    store = REPO / 'build' / 'chip_smoke_store'
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    initialize_distributed(f'file://{store}', 1, 0, 'cuda')
    try:
        check(dist.get_backend() == 'nccl', f'backend {dist.get_backend()}')
        report = dryrun_multichip(1, device='cuda', page_side=side,
                                  pages_per_rank=pages_per_rank)
    finally:
        dist.destroy_process_group()
    check(report['mesh'] == {'dp': 1, 'sp': 1, 'tp': 1}
          and report['label_px'] > 0 and report['sharded_ckpt'] == 'ok',
          f'dry run report {report}')
    return report


# ---------------------------------------------------------------------------
# Phase 8: the 17-step text-detection pipeline.
# ---------------------------------------------------------------------------

# Attempts of the pipeline in phase 8 (a) before it gives up with no sample.
PIPELINE_ATTEMPTS = 30
# Step 15's planner refuses a region scaled too far (a behaviour of the
# reference: an AssertionError raised in this file), and the pipeline's
# runner draws again; an error of any other kind fails the phase.
PLANNER_FILE = 'vkit_tpu_torch/ops/warp_mxu.py'
# The pipeline's crops, core 256 and pad 32 (synth/assets.py's configs).
PIPELINE_CROP = 320


class PipelineStop(BaseException):
    """Ends phase 8 (a) from inside PipelineRunner, whose retry catches
    every Exception: an error that is not the planner's, or the attempt
    limit."""


def _sample_post_processor():
    """The post-processor of phase 8's pipeline: the sample's page crops,
    text-region crops and stacked text-region page, as numpy, so that a
    spawned worker can send it."""
    import attr

    from vkit_tpu_torch.pipeline import (
        PageCroppingStepOutput,
        PageTextRegionCroppingStepOutput,
        PageTextRegionStepOutput,
        PipelinePostProcessor,
        PipelinePostProcessorFactory,
    )

    @attr.define
    class SampleConfig:
        pass

    @attr.define
    class SampleInput:
        page_cropping_step_output: PageCroppingStepOutput
        page_text_region_step_output: PageTextRegionStepOutput
        page_text_region_cropping_step_output: PageTextRegionCroppingStepOutput

    class SamplePostProcessor(
            PipelinePostProcessor[SampleConfig, SampleInput, dict]):

        def generate_output(self, input: SampleInput, rng):
            regions = input.page_text_region_step_output
            crops = input.page_text_region_cropping_step_output
            return {
                'page_crops': [
                    page.page_image.mat
                    for page in input.page_cropping_step_output.cropped_pages
                ],
                'region_page': regions.page_image.mat,
                'region_chars': len(regions.page_char_polygons),
                'region_crops': [
                    crop.page_image.mat
                    for crop in crops.cropped_page_text_regions
                ],
            }

    return PipelinePostProcessorFactory(SamplePostProcessor).create()


def build_smoke_pipeline(assets: dict, side: int, device: str = 'cuda'):
    """The 17 steps as tests/pipeline/fixtures.py configures them, on
    ``side`` x ``side`` pages, step 15 on ``device``.  Module-level, so a
    spawned pool worker can build it."""
    import logging

    from vkit_tpu_torch.pipeline import (
        Pipeline,
        pipeline_step_collection_factory,
    )
    from vkit_tpu_torch.synth.assets import build_step_configs

    # Step 16 warns once per char short of deviate labels and the runner
    # logs each failed attempt; phase 8 prints its own account.
    logging.getLogger('vkit_tpu_torch.pipeline').setLevel(logging.CRITICAL)
    return Pipeline(
        steps=pipeline_step_collection_factory.create(
            build_step_configs(assets, side, device)),
        post_processor=_sample_post_processor(),
    )


def check_sample(sample, what: str):
    shape = (PIPELINE_CROP, PIPELINE_CROP, 3)
    crops = sample['page_crops'] + sample['region_crops']
    check(len(sample['page_crops']) == 2 and sample['region_crops']
          and sample['region_chars'] > 0,
          f'{what}: {len(sample["page_crops"])} page crops, '
          f'{len(sample["region_crops"])} region crops, '
          f'{sample["region_chars"]} region chars')
    check(all(c.shape == shape and c.dtype == np.uint8 for c in crops),
          f'{what}: crop shapes {[c.shape for c in crops]}')
    page = sample['region_page']
    check(page.ndim == 3 and page.shape[2] == 3 and page.dtype == np.uint8
          and page.any(), f'{what}: stacked page {page.shape}')


def pipeline_run(assets: dict, side: int, max_seconds=None):
    """One sample of the 17-step pipeline under the port's PipelineRunner
    (the pool's retry: a failed attempt draws again from the moved rng),
    from seed 0, stopping at a sample, PIPELINE_ATTEMPTS attempts or
    ``max_seconds``.  Launch counters are zeroed just before and read just
    after; every row-shift launch is recorded (record_row_shifts).  Returns
    the account of each attempt (step seconds, source-tile buckets,
    launches, error), the sample, step 15's input and rng state at its
    entry in the last attempt, the launches and recorded calls."""
    import copy
    import traceback

    import torch

    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.ops import region as region_ops
    from vkit_tpu_torch.pipeline.pool import PipelineRunner

    pipeline = build_smoke_pipeline(assets, side)
    attempts, entry, samples = [], {}, []

    for step in pipeline.steps:
        def timed(input, rng, real=step.run, name=type(step).__name__):
            if name == 'PageTextRegionStep':
                entry.update(input=input,
                             rng_state=copy.deepcopy(rng.bit_generator.state))
            begin = time.perf_counter()
            try:
                return real(input, rng)
            finally:
                attempts[-1]['steps'][name] = time.perf_counter() - begin
        step.run = timed

    real_run = pipeline.run
    begin_all = time.perf_counter()

    def counted_run(rng, state=None):
        if len(attempts) == PIPELINE_ATTEMPTS or (
                max_seconds and time.perf_counter() - begin_all > max_seconds):
            raise PipelineStop(f'no sample in {len(attempts)} attempts, '
                               f'{time.perf_counter() - begin_all:.1f} s')
        before = dict(K.LAUNCHES)
        attempts.append({'steps': {}, 'buckets': [], 'error': None})
        begin = time.perf_counter()
        try:
            return real_run(rng, state)
        except Exception as error:
            where = traceback.extract_tb(error.__traceback__)[-1]
            attempts[-1]['error'] = f'{type(error).__name__}: {error}'
            if not (isinstance(error, AssertionError)
                    and where.filename.endswith(PLANNER_FILE)):
                raise PipelineStop(
                    f'attempt {len(attempts)}: {type(error).__name__} at '
                    f'{where.filename}:{where.lineno}: {error}') from error
            raise
        finally:
            attempts[-1]['seconds'] = time.perf_counter() - begin
            attempts[-1]['launches'] = {
                name: K.LAUNCHES[name] - before[name] for name in K.LAUNCHES
                if K.LAUNCHES[name] > before[name]}

    real_flatten = region_ops.batch_flatten_regions

    def flatten(patches, angles, scales, dst_tile, **kwargs):
        attempts[-1]['buckets'].append((tuple(patches.shape), dst_tile))
        return real_flatten(patches, angles, scales, dst_tile, **kwargs)

    pipeline.run = counted_run
    region_ops.batch_flatten_regions = flatten
    runner = PipelineRunner(pipeline=pipeline)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    begin = time.perf_counter()
    try:
        calls = record_row_shifts(
            lambda: samples.append(runner(0, np.random.default_rng(0),
                                          None)))
        stop = None
    except PipelineStop as error:
        calls, stop = [], str(error)
    finally:
        region_ops.batch_flatten_regions = real_flatten
    seconds = time.perf_counter() - begin
    launches = dict(K.LAUNCHES)
    return {'attempts': attempts, 'sample': samples[0] if samples else None,
            'stop': stop, 'entry': entry, 'seconds': seconds,
            'launches': launches, 'calls': calls,
            'peak_bytes': torch.cuda.max_memory_allocated()}


def pipeline_pool_sample(assets: dict, side: int, timeout: int = 300):
    """One sample from PipelinePool's production form: two spawned workers,
    each building the pipeline (step 15 on the card) and retrying as the
    runner does.  Returns the seconds to the first sample."""
    from functools import partial

    from vkit_tpu_torch.pipeline import PipelinePool

    begin = time.perf_counter()
    pool = PipelinePool(
        pipeline_factory=partial(build_smoke_pipeline, assets, side),
        inventory=1, num_processes=2, timeout=timeout)
    try:
        sample = pool.run()
    finally:
        pool.cleanup()
    check_sample(sample, 'pool (spawn)')
    return time.perf_counter() - begin


def _leaves(value, path, out):
    """Path -> leaf of a step output: arrays and scalars, each object's
    class name under ``path:type``; public attrs fields and slots."""
    import enum

    import attr

    if value is None or isinstance(value, (bool, int, float, str,
                                           np.generic, np.ndarray)):
        out[path] = value
    elif isinstance(value, enum.Enum):
        out[path] = value.name
    elif isinstance(value, dict):
        for key in value:
            _leaves(value[key], f'{path}[{key!r}]', out)
    elif isinstance(value, (list, tuple)):
        out[path + ':len'] = len(value)
        for i, item in enumerate(value):
            _leaves(item, f'{path}[{i}]', out)
    else:
        out[path + ':type'] = type(value).__name__
        names = ([f.name for f in attr.fields(type(value))]
                 if attr.has(type(value)) else
                 [s for c in type(value).__mro__
                  for s in getattr(c, '__slots__', ())])
        for name in names:
            if not name.startswith('_'):
                _leaves(getattr(value, name), f'{path}.{name}', out)
    return out


def step_outputs_close(card, host):
    """Step 15's outputs from the card and the CPU: every host field equal,
    rasters within 1 LSB (images) or 1e-5 (score maps) but for a share of
    REGION_EDGE_SHARE of their elements (outline pixels where the warped
    alpha's threshold flips).  Returns (leaves compared, raster elements
    that differ, the largest share beyond tolerance)."""
    a, b = _leaves(card, '', {}), _leaves(host, '', {})
    check(a.keys() == b.keys(), 'step 15 card vs CPU: other fields')
    differ, worst = 0, 0.0
    for path, x in a.items():
        y = b[path]
        if not isinstance(x, np.ndarray):
            check(x == y, f'step 15 card vs CPU: {path} {x} != {y}')
            continue
        check(x.shape == y.shape and x.dtype == y.dtype,
              f'step 15 card vs CPU: {path} {x.shape} != {y.shape}')
        if np.array_equal(x, y):
            continue
        kind = a.get(path[:-len('.mat')] + ':type')
        if kind == 'Image':
            off = np.abs(x.astype(np.int64) - y.astype(np.int64)) > 1
        elif kind == 'ScoreMap':
            off = np.abs(x - y) > 1e-5
        else:
            check(kind == 'Mask', f'step 15 card vs CPU: {path} differs')
            off = x != y
        worst = max(worst, float(off.mean()))
        check(off.mean() <= REGION_EDGE_SHARE,
              f'step 15 card vs CPU: {path}: {off.mean()} beyond 1 LSB')
        differ += int((x != y).sum())
    return len(a), differ, worst


def step15_card_vs_cpu(assets: dict, side: int, entry: dict):
    """Step 15 on the card and on the CPU from the input and rng state of
    a sample's step 15: the outputs close (step_outputs_close) and both
    rngs left alike.  Also the card's run under torch.profiler, for its
    device time.  Returns seconds and the comparison."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vkit_tpu_torch.pipeline import pipeline_step_collection_factory
    from vkit_tpu_torch.synth.assets import build_step_configs

    config = build_step_configs(assets, side)[14]
    out, seconds, states = {}, {}, {}
    for device in ('cuda', 'cpu'):
        step = pipeline_step_collection_factory.create(
            [dict(config, config={'device': device})])[0]
        rng = np.random.default_rng()
        rng.bit_generator.state = entry['rng_state']
        begin = time.perf_counter()
        out[device] = step.run(entry['input'], rng)
        seconds[device] = time.perf_counter() - begin
        states[device] = rng.bit_generator.state
        if device == 'cuda':
            rng.bit_generator.state = entry['rng_state']
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step.run(entry['input'], rng)
                torch.cuda.synchronize()
            # Device activities only (kernels, copies), not the host ops
            # that issued them nor the profiler's own buffer requests.
            kernels = {
                event.key: event.self_device_time_total
                for event in prof.key_averages()
                if event.device_type == DeviceType.CUDA
                and event.self_device_time_total > 0
                and event.key != 'Activity Buffer Request'
            }
    check(states['cuda'] == states['cpu'], 'step 15: the rngs part')
    leaves, differ, worst = step_outputs_close(out['cuda'], out['cpu'])
    return {'seconds': seconds, 'leaves': leaves, 'differ': differ,
            'worst_share': worst,
            'device_ms': sum(kernels.values()) / 1e3 if kernels else None,
            'device_kernels': {k: round(v / 1e3, 4) for k, v in
                               sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:6]}}


def pipeline_phase(assets: dict, side: int, card: str,
                   with_pool: bool = True, max_seconds=None):
    """Phase 8: (a) one sample at ``side`` under PipelineRunner, its
    attempts, step seconds, buckets and launches, each recorded row-shift
    launch bit for bit against its plain version and the largest of each
    kernel timed; (b) one sample from two spawned pool workers; (c) step
    15 on the card against the CPU.  Returns the launches of (a)."""
    import torch

    from vkit_tpu_torch.ops import kernels as K

    run = pipeline_run(assets, side, max_seconds=max_seconds)
    for index, attempt in enumerate(run['attempts']):
        log(f'    attempt {index + 1}: {attempt["seconds"]:.2f} s, steps '
            f'run {len(attempt["steps"])}, buckets {attempt["buckets"]}, '
            f'launches {attempt["launches"]}, '
            + (f'failed: {attempt["error"]}' if attempt['error']
               else 'sample'))
    check(run['stop'] is None and run['sample'] is not None,
          f'pipeline at {side}: {run["stop"]}')
    check_sample(run['sample'], f'pipeline at {side}')
    launches, calls = run['launches'], run['calls']
    check(launches['row_shift_window_slab'] > 0,
          f'step 15 launched no K1: {launches}')
    check(len(calls) == launches['row_shift_window_slab']
          + launches['row_shift'],
          f'{len(calls)} row-shift launches recorded, {launches} counted')
    for index, (name, args, kwargs) in enumerate(calls):
        x, starts, width = args
        kernel = getattr(K, name)
        plain = getattr(K, name + '_plain')
        extra = ((float(kwargs.get('border_value', 0.0)),)
                 if name == 'row_shift_window_slab' else ())
        _, exact = check_exact(
            f'{name}/pipeline launch {index + 1}',
            lambda: kernel(x, starts, width, *extra),
            lambda: plain(x, starts, width, *extra), tol=0.0)
        check(exact, f'{name}/pipeline launch {index + 1}: not bit-exact')
    last = run['attempts'][-1]
    shapes = [f'{name} {tuple(args[0].shape)} -> {args[2]}'
              for name, args, _ in calls[len(calls) - sum(
                  last['launches'].values()):]]
    for name in ('row_shift_window_slab', 'row_shift'):
        mine = [(args, kwargs) for n, args, kwargs in calls if n == name]
        if mine:
            args, kwargs = max(mine, key=lambda c: c[0][0].numel())
            label = f'{name}/pipeline largest of {len(mine)}'
            log_kernel('8 kernel', label,
                       compare_row_shift(label, name, args, kwargs), card)
    del calls
    run['calls'] = None
    torch.cuda.empty_cache()
    failures = {}
    for attempt in run['attempts'][:-1]:
        failures[attempt['error']] = failures.get(attempt['error'], 0) + 1
    steps = last['steps']
    step_sum = sum(steps.values())
    regions = sum(shape[0] for shape, _ in last['buckets'])
    # The warped stacks come back to the host whole, as the reference's do.
    back = sum(4 * shape[0] * shape[3] * dst * dst
               for shape, dst in last['buckets'])
    log(f'[8 pipeline] 17 steps at {side}x{side} under PipelineRunner from '
        f'seed 0: {len(run["attempts"])} attempts for 1 sample in '
        f'{run["seconds"]:.2f} s ({1 / run["seconds"]:.4f} samples/s); '
        f'failures {failures}; the sample\'s steps (s) '
        + ', '.join(f'{n} {s:.3f}' for n, s in steps.items())
        + f' (sum {step_sum:.3f}, step 15 {steps["PageTextRegionStep"] / step_sum:.3f} '
        f'of it); step 15 flattened {regions} regions in buckets '
        f'{last["buckets"]} (stack shape, dst tile), {back} bytes of warped '
        f'tiles copied back, row shifts {shapes}; peak device memory {run["peak_bytes"]} bytes '
        f'| launches {launches} over all attempts, all bit-exact | {card}')
    if with_pool:
        pool_seconds = pipeline_pool_sample(assets, side)
        log(f'[8 pool] PipelinePool(pipeline_factory=..., num_processes=2), '
            f'spawned workers with step 15 on the card: first sample in '
            f'{pool_seconds:.2f} s, crops {PIPELINE_CROP}x{PIPELINE_CROP} '
            f'| {card}')
    agree = step15_card_vs_cpu(assets, side, run['entry'])
    log(f'[8 card vs CPU] step 15 from the sample\'s input and rng state: '
        f'card {agree["seconds"]["cuda"]:.3f} s, CPU '
        f'{agree["seconds"]["cpu"]:.3f} s; {agree["leaves"]} fields '
        f'compared, host fields equal, {agree["differ"]} raster elements '
        f'differ (largest share beyond 1 LSB {agree["worst_share"]}); '
        f'device time of the card\'s step 15 under torch.profiler '
        + (f'{agree["device_ms"]:.3f} ms, '
           f'{agree["device_ms"] / 1e3 / step_sum:.4f} of the sample\'s '
           f'step sum; top kernels (ms) {agree["device_kernels"]}'
           if agree['device_ms'] is not None else 'not measured (no '
           'device events)')
        + f' | {card}')
    return launches


# ---------------------------------------------------------------------------
# Phase 9: batched_grid_warp and the single-image ops.
# ---------------------------------------------------------------------------

GRID_SIDE = 640
# Bench configs 2-4 through batched_grid_warp: (distortion, batch, the
# kernel its route must launch, seed).
GRID_CASES = {
    'grid-camera-32x640': ('camera_cubic_curve', 32, 'banded_line_resample',
                           910),
    'grid-mls-32x640': ('similarity_mls', 32, 'banded_line_resample', 920),
    'grid-rotate-64x640': ('rotate', 64, 'row_shift_window_slab', 930),
}
# Traced runs of the camera call: the spread of its busy time.
TRACED_GRID_RUNS = 5


def grid_configs(name: str, batch: int, side: int = GRID_SIDE):
    """bench.py's configs: _camera_config() (:250), the MLS handle points
    of bench_mls_glyphs (:331-343), rotate at 17 degrees (:232)."""
    from vkit_tpu_torch.element import Point

    if name == 'camera_cubic_curve':
        config = {
            'curve_alpha': 12, 'curve_beta': -10, 'curve_direction': 0,
            'curve_scale': 1.0,
            'camera_model_config': {
                'rotation_unit_vec': [1.0, 0.0, 0.0], 'rotation_theta': 6,
            },
            'grid_size': 16,
        }
    elif name == 'similarity_mls':
        config = {
            'src_handle_points': [
                Point.create(y=100, x=100), Point.create(y=100, x=side - 100),
                Point.create(y=side - 100, x=100),
                Point.create(y=side - 100, x=side - 100),
            ],
            'dst_handle_points': [
                Point.create(y=120, x=90), Point.create(y=80, x=side - 80),
                Point.create(y=side - 110, x=130),
                Point.create(y=side - 90, x=side - 120),
            ],
            'grid_size': 16,
        }
    else:
        check(name == 'rotate', f'no grid config for {name}')
        config = {'angle': 17.0}
    return [config] * batch


def grid_stack(seed: int, batch: int, side: int = GRID_SIDE):
    """bench.py's stack: random RGB as float32, a full mask and a random
    score map (_label_stack, :164)."""
    gen = np.random.default_rng(seed)
    stack = np.empty((batch, side, side, 5), dtype=np.float32)
    stack[..., :3] = gen.integers(0, 256, (batch, side, side, 3))
    stack[..., 3] = 1.0
    stack[..., 4] = gen.random((batch, side, side), dtype=np.float32)
    return stack


def grid_warp_case(device, label: str, side: int = GRID_SIDE):
    """One bench config through batched_grid_warp on the card: the counted
    call (its route's kernel must launch), the same call on the CPU (plain
    versions) within 1 LSB inside each sample's coverage eroded by 4 px,
    and s per call (median of 5 after 2 warm-ups, host planning included).
    Returns the readings and a function that repeats the call."""
    import torch
    from scipy.ndimage import binary_erosion

    from vkit_tpu_torch.mechanism import distortion
    from vkit_tpu_torch.mechanism.batched import batched_grid_warp
    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.ops import warp_banded, warp_mxu

    name, batch, kernel, seed = GRID_CASES[label]
    warp = getattr(distortion, name)
    configs = grid_configs(name, batch, side)
    stack_np = grid_stack(seed, batch, side)
    stack = torch.from_numpy(stack_np).to(device)

    def call(images=stack, **kwargs):
        return batched_grid_warp(warp, configs, images,
                                 rng=np.random.default_rng(seed), **kwargs)

    site = warp_banded if kernel == 'banded_line_resample' else warp_mxu
    results = []
    sync(device)
    K.reset_launch_counts()
    recorded = record_calls(lambda: results.append(call()), site, (kernel,))
    sync(device)
    launches = dict(K.LAUNCHES)
    out, shapes, covs = results[0]
    check(launches[kernel] > 0, f'{label}: {kernel} never launched: '
          f'{launches}')
    check(len(recorded) == launches[kernel],
          f'{label}: {len(recorded)} launches recorded, {launches} counted')
    check(out.shape[0] == batch and out.shape[3] == 5
          and out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
          f'{label}: output {tuple(out.shape)} {out.dtype}')
    host, host_shapes, _ = call(stack_np, device='cpu')
    check(host_shapes == shapes, f'{label}: shapes differ from the CPU run')
    out = out.cpu().numpy()
    host = host.numpy()
    worst = mean = 0.0
    for i, (h, w) in enumerate(shapes):
        core = binary_erosion(covs[i], iterations=4)
        check(core.sum() > h * w // 2, f'{label}: sample {i} barely covered')
        diff = np.abs(out[i, :h, :w] - host[i, :h, :w])[core]
        worst = max(worst, float(diff.max()))
        mean = max(mean, float(diff.mean()))
    check(worst <= 1.0, f'{label}: card vs CPU {worst} LSB')
    del out, host
    times = []
    for step in range(7):
        sync(device)
        begin = time.perf_counter()
        call()
        sync(device)
        if step >= 2:
            times.append(time.perf_counter() - begin)
    seconds = statistics.median(times)
    return {'launches': launches, 'max_lsb': worst, 'mean_lsb': mean,
            'seconds': seconds, 'images_per_s': batch / seconds,
            'shape': tuple(shapes[0]), 'times': times,
            'recorded': recorded}, call


def compare_recorded(label: str, name: str, args, kwargs):
    """compare() of one recorded launch: K1 / K2 bit for bit
    (compare_row_shift), K3 within 1e-3 with its grid_sample yardstick."""
    from vkit_tpu_torch.ops import kernels as K

    if name != 'banded_line_resample':
        return compare_row_shift(label, name, args, kwargs)
    x, base, pos, taps = args
    border = float(kwargs.get('border_value', 0.0))
    library, close, _, _ = banded_grid_sample_library(x, base, pos, taps,
                                                      border)
    result = compare(
        label,
        lambda: K.banded_line_resample(x, base, pos, taps, border),
        lambda: K.banded_line_resample_plain(x, base, pos, taps, border),
        tol=1e-3, work=banded_work(x, base, pos, taps),
        library_fn=library, library_close=close)
    result['shape'] = f'{tuple(x.shape)} -> {pos.shape[-1]}, taps {taps}'
    return result


def _smooth_page(gen, shape):
    from scipy.ndimage import gaussian_filter

    sigma = (1.5, 1.5, 0)[:len(shape)]
    return gaussian_filter(gen.random(shape) * 255, sigma=sigma).astype(
        np.uint8)


def _jpeg_close(got, want):
    """ops/effect.py jpeg_quality's tolerance (tests/test_torch_api_tail.py):
    at most 4% of the pixels apart, mean 0.15 LSB, max 32."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return ((diff > 0).mean() <= 0.04 and diff.mean() <= 0.15
            and diff.max() <= 32), float(diff.max())


def single_image_ops(device, side: int = GRID_SIDE):
    """The reference's single-image ops at 640 x 640 on the card against
    the CPU, each within its tolerance, with its ms (CUDA events).
    Returns {op: (max LSB apart, ms)}."""
    import torch

    from vkit_tpu_torch.ops import blur, color, effect, warp

    gen = np.random.default_rng(940)
    image = _smooth_page(gen, (side, side, 3))
    gray = _smooth_page(gen, (side, side))
    theta = np.radians(5.0)
    c = (side - 1) / 2
    affine = np.array([
        [np.cos(theta), -np.sin(theta), c - np.cos(theta) * c
         + np.sin(theta) * c + 7],
        [np.sin(theta), np.cos(theta), c - np.sin(theta) * c
         - np.cos(theta) * c - 5],
    ])
    perspective = np.array([[1.02, 0.06, -12.0], [0.03, 0.97, 9.0],
                            [4e-5, -3e-5, 1.0]])
    ys, xs = np.mgrid[0:side, 0:side].astype(np.float64)
    map_y = (ys + 6 * np.sin(xs / 31)).astype(np.float32)
    map_x = (xs + 5 * np.cos(ys / 23)).astype(np.float32)

    def lsb(limit):
        def close(got, want):
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            return float(diff.max()) <= limit, float(diff.max())
        return close

    def nearest_flips(got, want):
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        return float((diff > 0).mean()) <= 1e-3, float(diff.max())

    # (op, its call on tensors of a device, its check of card vs CPU).
    cases = [
        ('warp_affine', lambda d: warp.warp_affine(
            image_on[d], mats[d][0], (side, side), 'bilinear', 255.0),
         lsb(1)),
        ('warp_perspective', lambda d: warp.warp_perspective(
            image_on[d], mats[d][1], (side, side), 'bilinear', 255.0),
         lsb(1)),
        # A numpy matrix: the maps are built on the image's device.
        ('warp_perspective numpy matrix', lambda d: warp.warp_perspective(
            image_on[d], perspective, (side, side), 'bilinear', 255.0),
         lsb(1)),
        ('warp_affine nearest', lambda d: warp.warp_affine(
            image_on[d], mats[d][0], (side, side), 'nearest', 255.0),
         nearest_flips),
        ('remap nearest', lambda d: warp.remap(
            image_on[d], *maps[d], 'nearest', 255.0), lsb(0)),
        ('remap bilinear', lambda d: warp.remap(
            image_on[d], *maps[d], 'bilinear', 255.0), lsb(1)),
        ('equalize_hist', lambda d: color.equalize_hist(gray_on[d]), lsb(0)),
        ('gaussian_blur', lambda d: blur.gaussian_blur(image_on[d], 1.5),
         lsb(1)),
        ('box_blur', lambda d: blur.box_blur(image_on[d], 5), lsb(1)),
        ('jpeg_quality', lambda d: effect.jpeg_quality(image_on[d], 50),
         _jpeg_close),
        ('pixelation', lambda d: effect.pixelation(image_on[d], (160, 160)),
         lsb(1)),
    ]
    cpu = torch.device('cpu')
    image_on, gray_on, mats, maps = {}, {}, {}, {}
    for d in (device, cpu):
        image_on[d] = torch.from_numpy(image).to(d)
        gray_on[d] = torch.from_numpy(gray).to(d)
        mats[d] = [torch.from_numpy(m).to(d) for m in (affine, perspective)]
        maps[d] = [torch.from_numpy(m).to(d) for m in (map_y, map_x)]
    check(warp.affine_maps(perspective, (side, side))[0].device.type
          == device.type, 'affine_maps built a numpy matrix\'s maps off the '
          'card')
    results = {}
    for op, fn, close in cases:
        got = fn(device)
        sync(device)
        check(got.device.type == device.type, f'{op} left the card')
        ok, worst = close(got.cpu().numpy(), fn(cpu).numpy())
        check(ok, f'{op}: card vs CPU {worst} LSB')
        results[op] = (worst, time_ms(lambda: fn(device)))
    return results


def grid_phase(device, card: str):
    """Phase 9: bench configs 2-4 through batched_grid_warp, (a) once more
    under device_trace, and the single-image ops.  Returns the launches of
    the three counted calls, summed."""
    from vkit_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.LAUNCHES}
    repeat = None
    for label in GRID_CASES:
        res, call = grid_warp_case(device, label)
        for name, count in res['launches'].items():
            launches[name] += count
        name, batch = GRID_CASES[label][:2]
        log(f'[9 {label}] batched_grid_warp({name}, {batch} x '
            f'{GRID_SIDE}x{GRID_SIDE}x5) -> {res["shape"]}: '
            f'{res["seconds"]} s per call (median of 5 after 2 warm-ups, '
            f'host planning included; {res["times"]}), '
            f'{res["images_per_s"]} images/s | launches {res["launches"]} '
            f'| card vs CPU inside the coverage eroded by 4 px: max '
            f'{res["max_lsb"]} LSB, worst sample mean {res["mean_lsb"]} '
            f'| {card}')
        # The case's largest launch, timed with its bound.
        kernel_name, args, kwargs = max(
            res.pop('recorded'), key=lambda c: c[1][0].numel())
        timed = compare_recorded(label, kernel_name, args, kwargs)
        log_kernel('9 kernel', f'{kernel_name}/{label} largest of '
                   f'{res["launches"][kernel_name]}', timed, card)
        del args, kwargs
        if repeat is None:
            repeat = call
        torch_empty_cache()
    sync(device)
    readings, _ = traced_runs(device, repeat, TRACED_GRID_RUNS)
    log_traced('9 trace grid-camera-32x640 under device_trace', readings,
               card)
    del repeat
    torch_empty_cache()
    ops = single_image_ops(device)
    log('[9 single-image ops] 640x640, card vs CPU max LSB apart and ms per '
        'call: ' + ', '.join(f'{op} {worst} LSB {ms:.4f} ms'
                             for op, (worst, ms) in ops.items())
        + f' | {card}')
    return launches


def torch_empty_cache():
    import torch

    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on a GPU only',
              file=sys.stderr)
        return 2
    if not (REPO / 'vkit_tpu_torch').is_dir():
        print('chip_smoke: vkit_tpu_torch/ not found beside this script',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    modules = import_the_port()
    from vkit_tpu_torch.host import native_geometry_loaded
    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.synth.assets import (
        build_assets,
        find_font,
        make_planner,
    )

    device = torch.device('cuda', 0)
    # float32 products (the node upsamples) in full precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()

    # 1. Environment.
    libs = probe_host_libraries()
    font = find_font(ASSETS)
    log(f'[1 environment] torch {torch.__version__} cuda {torch.version.cuda} '
        f'| {card} | host libs {libs} | font {font.name} '
        f'| native geometry {native_geometry_loaded()} '
        f'| {modules} port modules imported, no jax, no vkit_tpu '
        f'| allow_tf32 {torch.backends.cuda.matmul.allow_tf32}')

    # 2. Build.
    begin = time.perf_counter()
    lib_path = K.library_path()
    K.load_library()
    log(f'[2 build] {lib_path.name}: nvcc {K.BUILD_SECONDS} s, '
        f'load {time.perf_counter() - begin:.3f} s')
    report = ptxas_report(K.build_log())
    check(report, 'no ptxas report of banded_resample_kernel in the build '
          'log')
    log('[2 ptxas] banded_resample_kernel <channels unrolled, 0 for the '
        'runtime loop>: ' + ' | '.join(
            f'<{c}> {line}' for c, line in sorted(report.items())))

    # 3. Kernels against their plain versions, K1 and K3 at the arguments
    # of their first launch in a synth-640 batch.
    assets = build_assets(ASSETS, font)
    planner = make_planner(assets, 640)
    captured, per_batch = capture_main_path_args(device, planner)
    log(f'[3 capture] launches in one synth-640 batch (8 pages, level 5, '
        f'text-region stream on): {per_batch}')
    kernels = kernel_phase(device, captured)
    kernels.update(two_shear_phase(device, captured))
    del captured
    # K1 and K2 as phase 6's other two paths launch them: the same seeds
    # give phase 6 the same arguments.
    chain_images, chain = chain_inputs(device, seed=CHAIN_SEED)
    dense_in = dense_inputs(device, seed=DENSE_SEED)
    # K1's other shapes are log lines; the JSON line has one entry a kernel.
    shapes = dict(kernels)
    shapes.update(path_kernel_phase(device, chain, *dense_in[1:3]))
    for label in [label for label in kernels if '/' in label]:
        del kernels[label]
    del chain_images, chain, dense_in
    torch.cuda.empty_cache()
    for name, res in shapes.items():
        log_kernel('3 kernel', name, res, card)

    if '--kernels-only' in sys.argv[1:]:
        return 0
    if '--pipeline-area' in sys.argv[1:]:
        # Phase 8 alone at another page side (no pool, 15 minutes at most).
        side = int(sys.argv[sys.argv.index('--pipeline-area') + 1])
        pipeline_phase(assets, side, card, with_pool=False, max_seconds=900)
        return 0

    # Every K3 launch shape of phases 4-9, at the site the paths call.
    k3_shapes, restore_k3 = count_banded_shapes()

    # 4. Main path.
    main_path(device, planner, seed=100)           # warm-up, not counted
    launches = rates = None
    for seed in range(101, 106):
        K.reset_launch_counts()
        rates = main_path(device, planner, seed)
        launches = dict(K.LAUNCHES)
        if all(launches[name] for name in MAIN_PATH_KERNELS):
            break
        log(f'    seed {seed}: launches {launches}; drawing another seed')
    check(all(launches[name] for name in MAIN_PATH_KERNELS),
          f'a kernel never launched: {launches}')
    small = make_planner(assets, 320)
    img_err, lab_err = small_batch_agreement(device, small)
    region_err = region_agreement(device, small)
    photo_err = photometric_agreement(device, small)
    log(f'[4 main path] synthesize_stream {rates["synth_pages_per_s"]} '
        f'pages/s (2 batches of 8, {rates["synth_crops"]} crops, '
        f'photometric stage on, text-region stream on: '
        f'{rates["region_pages"]} stacked pages, {rates["region_crops"]} '
        f'region crops), batch_random_geometric_distort '
        f'{rates["distort_images_per_s"]} images/s, spread split '
        f'{rates["spread_pages_per_s"]} pages/s | launches {launches} '
        f'| card vs CPU: {img_err} LSB, labels {lab_err}, text regions '
        f'(share of pixels apart) {region_err}, deterministic '
        f'photometric stage {photo_err} LSB | {card}')
    log_traced('4 trace synth-640 batch under device_trace(host=False)',
               traced_synth_batches(device, planner, seed=120), card)
    off_rate, off_crops, _, _ = stream_rate(device, planner, 110,
                                            num_batches=2, regions=False)
    log(f'[4 region off] synthesize_stream {off_rate} pages/s (2 batches of '
        f'8, {off_crops} crops, photometric stage on, text-region stream '
        f'off: the main path of earlier revisions) | {card}')
    spans, regions_per_batch = stage_spans(device, planner, seed=200)
    # The region.* spans lie inside ``region``.
    total = sum(sec for name, sec in spans.items()
                if not name.startswith('region.'))
    log('[4 stages] synthesize_page_batch s per 8-page batch (timer spans, '
        'mean of 2, char gaussian maps and text-region stream on, '
        f'{regions_per_batch} regions per batch): '
        + ', '.join(f'{name} {sec}' for name, sec in spans.items())
        + f' | sum without the region.* sub-spans {total} | {card}')
    log(f'[4 region] {spans["region"]} s per 8-page batch, '
        f'{spans["region"] / total} of the spans\' sum; char-gaussians '
        f'{spans["char-gaussians"]} s | {card}')
    log(f'[4 photometric] {spans["photometric"]} s per 8-page batch '
        f'(synth-640, level 5), {spans["photometric"] / total}'
        f' of the spans\' sum | {card}')
    random_rate, step_times = random_distortion_rate(device, seed=300)
    log(f'[4 RandomDistortion] {random_rate} images/s over 6 timed steps of '
        f'32 x 640x640 after 8 warm-ups; step seconds {step_times} | {card}')

    # 5. The photometric catalog on the card.
    catalog = catalog_phase(device)
    log('[5 catalog] ' + ', '.join(
        f'{name} {res["seconds"]:.4f} s'
        + ('' if res['max_abs_err'] is None
           else f' (err {res["max_abs_err"]})')
        for name, res in catalog.items()
    ) + f' | {card}')

    # 6. The training path, the one-program chain, the dense two-pass: each
    # with the launch counters zeroed just before and read just after.
    K.reset_launch_counts()
    state, train = training_path(device, planner, seed=500)
    train_launches = dict(K.LAUNCHES)
    check(all(train_launches[name] for name in TRAINING_PATH_KERNELS),
          f'a kernel never launched on the training path: {train_launches}')
    log(f'[6 training] synthesize_stream (bench config 6\'s program, char '
        f'gaussian maps on) -> synth_to_train_batch -> train step of the '
        f'default TextDetectionNet (64-128-256-512, FPN 128, bfloat16, '
        f'{train["parameters"]} parameters), 8 x 640x640: '
        f'{train["pages_per_s"]} pages/s over 5 batches from the first '
        f'request to the last step (the warm-up step, '
        f'{train["warmup_step_seconds"]} s, included); s per train step in '
        f'the loop {train["loop_step_seconds"]}, alone on a repeated batch '
        f'{train["alone_step_seconds"]}; losses {train["losses"]}, on the '
        f'repeated batch {train["repeat_losses"]}; peak device memory '
        f'{train["peak_bytes"]} bytes over the loop, '
        f'{train["step_peak_bytes"]} bytes over the repeated steps alone '
        f'| launches {train_launches} | {card}')
    forward_err = detector_agreement(device)
    ckpt_seconds, ckpt_bytes = checkpoint_round_trip(state)
    log(f'[6 detector] narrow net float32 forward card vs CPU {forward_err}; '
        f'checkpoint save from the card + restore onto it {ckpt_seconds} s, '
        f'{ckpt_bytes} bytes on disk, tensors, step and metadata equal '
        f'| {card}')
    del state

    chain_images, chain = chain_inputs(device, seed=CHAIN_SEED)
    K.reset_launch_counts()
    chain_rate = chain_path(device, chain_images, chain)
    chain_launches = dict(K.LAUNCHES)
    check(chain_launches['row_shift_window_slab']
          + chain_launches['row_shift'] > 0,
          f'the chain launched no row-shift kernel: {chain_launches}')
    chain_err = chain_agreement(device)
    prefetch_check(device)
    log(f'[6 chain] synthesize_batch {chain_rate} images/s (batch 64 of '
        f'640x640x3 uint8, level 5, out 640x640; 5 steps of a plain loop '
        f'after 2 warm-ups) | launches {chain_launches} | noise off at 320 '
        f'px, card vs CPU {chain_err} LSB; prefetch_map keeps order onto the '
        f'card | {card}')
    del chain_images, chain
    torch.cuda.empty_cache()

    dense = dense_path(device, *dense_inputs(device, seed=DENSE_SEED))
    log(f'[6 dense] batched_plan_warp(mode=\'dense\') 8 x 640x640x5 -> '
        f'672x672, mild camera plans ({dense["drawn"]} drawn for 8 that the '
        f'two-pass takes): {dense["seconds"]} s with host planning | '
        f'launches {dense["launches"]} | vs mode=\'gather\' inside the '
        f'active masks: mean {dense["mean_vs_gather"]} LSB (4 px in), max '
        f'{dense["max_vs_gather"]} LSB (16 px in) | card vs CPU '
        f'{dense["card_vs_cpu"]} | {card}')
    torch.cuda.empty_cache()

    # 7. The multi-device path, each row-shift launch's arguments recorded
    # in the counted run and its kernel held to its plain version after.
    K.reset_launch_counts()
    reports = []
    multi_calls = record_row_shifts(
        lambda: reports.append(multidevice_path()))
    multi_launches = dict(K.LAUNCHES)
    multi = reports[0]
    check(multi_launches['row_shift_window_slab'] > 0,
          f'K1 never launched on the multi-device path: {multi_launches}')
    check(len(multi_calls) == multi_launches['row_shift_window_slab']
          + multi_launches['row_shift'],
          f'{len(multi_calls)} row-shift launches recorded, '
          f'{multi_launches} counted')
    for index, (name, args, kwargs) in enumerate(multi_calls):
        label = f'{name}/multidevice launch {index + 1} of {len(multi_calls)}'
        log_kernel('7 kernel', label,
                   compare_row_shift(label, name, args, kwargs), card)
    del multi_calls
    torch.cuda.empty_cache()
    log(f'[7 multi-device] dryrun_multichip(1, device=\'cuda\'), NCCL, '
        f'mesh {multi["mesh"]}: first sharded step (batch '
        f'{multi["batch"]}, default net bfloat16) {multi["step_seconds"]} s, '
        f'loss {multi["loss"]}; 8 composed 640x640 pages -> chain + label '
        f'warp + bridge {multi["gen_seconds"]} s; train step on them '
        f'{multi["gen_train_step_seconds"]} s (first at this shape), loss '
        f'{multi["gen_train_loss"]}, label_px {multi["label_px"]}; bytes to '
        f'collectives in that step {multi["gen_train_step_traffic"]}; '
        f'sharded checkpoint {multi["sharded_ckpt"]} '
        f'| launches {multi_launches} | {card}')

    # 8. The 17-step text-detection pipeline, step 15 on the card.
    begin = time.perf_counter()
    pipeline_launches = pipeline_phase(assets, 640, card)
    log(f'[8 done] phase 8 in {time.perf_counter() - begin:.1f} s')

    # 9. batched_grid_warp at bench configs 2-4, the single-image ops.
    begin = time.perf_counter()
    grid_launches = grid_phase(device, card)
    log(f'[9 done] phase 9 in {time.perf_counter() - begin:.1f} s')
    restore_k3()
    unrolled = sorted(c for c in report if c)
    log('[9 K3 shapes] banded_line_resample launches over phases 4-9 by '
        '(N, L, C, W, JP, taps), warm-ups included: '
        + ', '.join(f'{shape} x{count}'
                    for shape, count in sorted(k3_shapes.items()))
        + f'; channel counts {sorted({k[2] for k in k3_shapes})}, unrolled '
        f'instantiations {unrolled}')

    by_path = {'serving': launches, 'training': train_launches,
               'chain': chain_launches, 'dense': dense['launches'],
               'multidevice': multi_launches, 'pipeline': pipeline_launches,
               'grid': grid_launches}

    print(json.dumps({'kernels': [
        {
            'name': name, 'route': 'cuda',
            'source': KERNEL_SOURCES[name][0],
            'replaces': KERNEL_SOURCES[name][1],
            'launches': sum(counts[name] for counts in by_path.values()),
            'launches_by_path': {path: counts[name]
                                 for path, counts in by_path.items()},
            'max_abs_err': res['max_abs_err'],
            'ms': res['ms'], 'plain_ms': res['plain_ms'],
            'bound_ms': res['bound_ms'], 'bound_by': res['bound_by'],
            'library_ms': res['library_ms'],
        }
        for name, res in kernels.items()
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
