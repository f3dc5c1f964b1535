#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vkit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (plus detail lines):
  1. environment: torch / CUDA versions, the card's name and power limit,
     the host libraries the port's host layers need, the font, and the
     native geometry library; every module of vkit_tpu_torch is imported,
     and the phase fails if that loaded jax or any vkit_tpu module;
  2. build: nvcc builds the CUDA kernels from vkit_tpu_torch/ops/csrc;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card (max abs difference), and its time beside the plain version's,
     one library call's (`library_ms`, where one PyTorch call computes the
     same function) and its bound (the bytes the call must move over the
     card's memory rate, or its operations over the float32 rate).  K1
     (row_shift_window_slab) and K3 (banded_line_resample) run at the
     arguments of their first launch in one synth-640 batch, captured
     there with their launches per batch; K1 also at starts that wrap mod
     2048 and K3 at each rung of its tap ladder, for exactness only.  K4
     (row_shift_window), which no path calls, runs at K1's captured rows'
     RGB planes, one plane per row; K2 (row_shift), which only the spread
     split routes, at a 1400-lane source cut to 700 outputs;
  4. main path: full-content 640x640 pages through synthesize_stream
     (batch 8, level 5, two 512x512 crops per page, the photometric stage
     on as by default), RandomDistortion at bench config 5's shape (32 x
     640x640 uint8 + 2 label channels: the photometric stage, then the
     geometric plans rescaled to 704x704 and one batched_plan_warp), the
     random geometric distortion of 32 x 640x640 x 5 channels, and two-page
     spreads (640 x 1400) split into deskewed single pages by
     batched_plan_warp.  Launch counters are zeroed just before and read
     just after; K1-K3 must have launched.  Outputs must be finite with the
     expected shapes, and 320x320 batches on the card must agree with the
     same batches on the CPU: synthesis with the photometric stage off, and
     the photometric stage restricted to its deterministic ops.  Then,
     outside the counted run: synthesize_page_batch's own stage spans
     (the photometric stage's seconds per 8-page batch), and
     RandomDistortion images/s over bench config 5's step, label
     co-transform and content boxes included (8 warm-ups, 6 timed steps);
  5. photometric catalog: each of the 25 catalog names once over 8 x
     640x640 uint8 with policy-sampled level-5 configs (6 members, 2
     samples passing through), and one round of the one-program catalog
     with a different op per sample.  Deterministic ops are held to the
     same call on the CPU; rng-consuming ops to their configs' moments.
Then one JSON line of per-kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Any failure raises (exit code != 0).
`launches` in the JSON line counts the phase-4 run only, so K4 reads 0.
Parity with the CPU assumes TF32 off for matmuls and cuDNN, as set here.
The script needs a CUDA card and the rest of the repository beside it.
"""
import importlib
import importlib.metadata
import importlib.util
import json
import pkgutil
import statistics
import string
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
ASSETS = REPO / 'build' / 'chip_smoke_assets'
ASCII_CHARS = sorted(set(
    string.ascii_letters + string.digits + string.punctuation
))
KERNEL_SOURCES = {
    'row_shift_window_slab': ('vkit_tpu_torch/ops/csrc/row_shift.cu',
                              'vkit_tpu/ops/pallas_kernels.py:157'),
    'row_shift': ('vkit_tpu_torch/ops/csrc/row_shift.cu',
                  'vkit_tpu/ops/pallas_kernels.py:26'),
    'banded_line_resample': ('vkit_tpu_torch/ops/csrc/banded_resample.cu',
                             'vkit_tpu/ops/pallas_kernels.py:341'),
    'row_shift_window': ('vkit_tpu_torch/ops/csrc/row_shift.cu',
                         'vkit_tpu/ops/pallas_kernels.py:136'),
}
# The kernels the main path runs; K4 has no caller on any path.
MAIN_PATH_KERNELS = ('row_shift_window_slab', 'row_shift',
                     'banded_line_resample')
# The card's published peaks (H100 SXM data sheet): device memory bytes/s,
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Why K3 has no library yardstick.
K3_NO_LIBRARY = ('no single PyTorch call computes the two-tap hat resample '
                 'masked to [0, taps) through the 2048-lane window')
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
    flax, optax or any vkit_tpu module.  Returns the module count."""
    import vkit_tpu_torch

    names = [info.name for info in pkgutil.walk_packages(
        vkit_tpu_torch.__path__, 'vkit_tpu_torch.')]
    for name in names:
        importlib.import_module(name)
    loaded = sorted(name for name in sys.modules if name.split('.')[0] in
                    ('jax', 'jaxlib', 'flax', 'optax', 'vkit_tpu'))
    check(not loaded, f'importing the port loaded {loaded[:8]}')
    return len(names)


def find_font() -> Path:
    """A DejaVu Sans TTF (matplotlib's data or /usr/share/fonts); without
    one, the FreeType font Pillow bundles, written out as a file."""
    candidates = []
    spec = importlib.util.find_spec('matplotlib')
    if spec is not None and spec.origin:
        candidates += sorted(
            (Path(spec.origin).parent / 'mpl-data' / 'fonts' / 'ttf')
            .glob('DejaVuSans*.ttf')
        )
    candidates += sorted(Path('/usr/share/fonts').rglob('DejaVuSans*.ttf'))
    sans = sorted(
        (p for p in candidates
         if 'Mono' not in p.name and 'Display' not in p.name),
        key=lambda p: (p.name != 'DejaVuSans.ttf', str(p)),
    )
    if sans:
        return sans[0]
    from PIL import ImageFont

    font = ImageFont.load_default(size=32)
    data = getattr(font, 'font_bytes', None)
    check(bool(data), 'no TTF font found and Pillow bundles none')
    family = '-'.join(font.getname())
    path = ASSETS / 'fonts' / f'{family}.ttf'
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path


def build_assets(font_file: Path) -> dict:
    """Lexicon, font collection, corpus, background and symbol images for
    the page planner (the same set tests/pipeline/fixtures.py builds)."""
    import shutil

    from PIL import Image

    root = ASSETS
    root.mkdir(parents=True, exist_ok=True)
    lexicon_json = root / 'lexicon.json'
    lexicon_json.write_text(json.dumps([
        {'char': char, 'aliases': [], 'tags': ['ascii']}
        for char in ASCII_CHARS
    ]))
    font_fd = root / 'font_collection' / 'font'
    meta_fd = root / 'font_collection' / 'font_meta'
    font_fd.mkdir(parents=True, exist_ok=True)
    meta_fd.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(font_file, font_fd / font_file.name)
    (meta_fd / 'font.json').write_text(json.dumps({
        'name': font_file.stem,
        'mode': 'vttc',
        'char_to_tags': {char: ['ascii'] for char in ASCII_CHARS},
        'font_files': [font_file.name],
        'font_glyph_info_collection': {'font_glyph_infos': [{
            'tags': ['ascii'],
            'ascent_plus_pad_up_min_to_font_size_ratio': 0.8,
            'height_min_to_font_size_ratio': 1.0,
            'width_min_to_font_size_ratio': 0.6,
        }]},
    }))
    corpus_txt = root / 'corpus.txt'
    corpus_txt.write_text('\n'.join([
        'the quick brown fox jumps over the lazy dog 0123456789',
        'pack my box with five dozen liquor jugs',
        'sphinx of black quartz judge my vow',
        'how vexingly quick daft zebras jump',
    ] * 25))
    rng = np.random.default_rng(0)
    bg_fd = root / 'bg_images'
    bg_fd.mkdir(exist_ok=True)
    for idx in range(2):
        small = rng.integers(140, 235, (8, 8, 3), dtype=np.uint8)
        mat = np.kron(small, np.ones((40, 40, 1), dtype=np.uint8))
        Image.fromarray(mat).save(bg_fd / f'bg_{idx}.png')
    symbol_fd = root / 'symbol_images'
    symbol_fd.mkdir(exist_ok=True)
    for idx in range(2):
        mat = np.zeros((32, 32), dtype=np.uint8)
        mat[4:28, 14:18] = 255
        mat[14:18, 4:28] = 255
        Image.fromarray(mat.T.copy() if idx else mat).save(
            symbol_fd / f'symbol_{idx}.png'
        )
    return {
        'lexicon_json': str(lexicon_json),
        'font_collection_folder': str(root / 'font_collection'),
        'corpus_txt': str(corpus_txt),
        'bg_image_folder': str(bg_fd),
        'symbol_image_folder': str(symbol_fd),
    }


def make_planner(assets: dict, side: int):
    from vkit_tpu_torch.host import SynthPlanner, SynthPlannerConfig

    selector = [{'type': 'selector', 'weight': 1,
                 'config': {'image_folders': [assets['bg_image_folder']]}}]
    return SynthPlanner(SynthPlannerConfig(
        lexicon_collection_json=assets['lexicon_json'],
        font_collection_folder=assets['font_collection_folder'],
        char_sampler_configs=[{
            'type': 'corpus', 'weight': 1,
            'config': {'txt_files': [assets['corpus_txt']]},
        }],
        page_height=side, page_width=side,
        # Full page content: every page_assembler layer.
        background_image_configs=selector,
        image_configs=selector,
        symbol_image_folders=[assets['symbol_image_folder']],
        enable_barcodes=True,
        enable_seal_impressions=True,
        enable_text_line_bounding_boxes=True,
    ))


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


def compare(name, kernel_fn, plain_fn, tol: float, work, library_fn=None):
    """Max abs difference of kernel and plain outputs, and the times of
    kernel, plain version and library call, measured in turns (plain,
    kernel, library, library, kernel, plain).  ``work`` is (bytes,
    operations) of the call; the library call must equal the plain
    version bit for bit."""
    import torch

    err, exact = check_exact(name, kernel_fn, plain_fn, tol)
    if library_fn is not None:
        check(torch.equal(library_fn(), plain_fn()),
              f'{name}: the library call computes something else')
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


def capture_main_path_args(device, planner, seed: int = 400, batch: int = 8,
                           side: int = 640):
    """Runs one synth-640 batch (level 5, two crops per page, photometric
    stage on) with recorders around the K1 and K3 wrappers that
    ops/warp_mxu.py and ops/warp_banded.py call.  Returns {kernel: (args,
    kwargs) of its first launch, copied} and the batch's launches per
    kernel.  Untimed, and outside the counted main-path run."""
    import torch

    from vkit_tpu_torch.ops import kernels as K
    from vkit_tpu_torch.ops import warp_banded, warp_mxu
    from vkit_tpu_torch.synth import CropConfig, synthesize_page_batch

    captured = {}
    sites = ((warp_mxu, 'row_shift_window_slab'),
             (warp_banded, 'banded_line_resample'))
    originals = [getattr(module, name) for module, name in sites]

    def recorder(name, real):
        def record(*args, **kwargs):
            if name not in captured:
                captured[name] = (
                    [a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args], dict(kwargs))
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
            synthesize_page_batch(pages, 5, rng, crop_config=crop,
                                  keep_on_device=True, device=device)
            sync(device)
        finally:
            for (module, name), real in zip(sites, originals):
                setattr(module, name, real)
        launches = {name: K.LAUNCHES[name] - before[name]
                    for name in ('row_shift_window_slab',
                                 'banded_line_resample')}
        if len(captured) == len(sites):
            return captured, launches
        log(f'    capture batch {attempt}: launches {launches}; '
            'drawing another batch')
        captured.clear()
        before = dict(K.LAUNCHES)
    raise RuntimeError('chip_smoke: no synth-640 batch launched K1 and K3')


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
    m_shift, m_padded = statics.m_shift, statics.m_padded
    j = torch.arange(m_shift, device=device)
    first = rows.to(torch.int64).clamp(0, m_padded - 1)
    last = (rows.to(torch.int64) + m_shift - 1).clamp(0, m_padded - 1)
    k2_floats = (int((last - first + 1).sum()) + rows.numel()
                 + rows.numel() * m_shift)
    idx2 = (rows.to(torch.int64)[..., None] + j).clamp(0, m_padded - 1)
    results['row_shift'] = compare(
        'row_shift',
        lambda: K.row_shift(x_p, rows, m_shift),
        lambda: K.row_shift_plain(x_p, rows, m_shift),
        tol=0.0, work=(4.0 * k2_floats, 0.0),
        library_fn=lambda: torch.gather(x_p, 2, idx2),
    )
    results['row_shift']['shape'] = f'{tuple(x_p.shape)} -> {m_shift}'
    log(f'    row_shift statics: {statics}')
    del x_p, rows, idx2

    # K3 at its first launch in a synth-640 batch.
    (xb, base, pos, taps), kwargs = captured['banded_line_resample']
    border = float(kwargs.get('border_value', 0.0))
    results['banded_line_resample'] = compare(
        'banded_line_resample',
        lambda: K.banded_line_resample(xb, base, pos, taps, border),
        lambda: K.banded_line_resample_plain(xb, base, pos, taps, border),
        tol=1e-3, work=banded_work(xb, base, pos, taps),
    )
    results['banded_line_resample']['shape'] = (
        f'{tuple(xb.shape)} -> {pos.shape[-1]}, taps {taps}')
    # Exactness only: each rung of the tap ladder at random bases.
    n, lines = xb.shape[:2]
    jp = 768
    groups = -(-lines // 8)
    for rung in (32, 64, 128):
        base_np = gen.integers(-500, 1281, (n, groups, jp // 128))
        full = np.repeat(np.repeat(base_np, 8, 1)[:, :lines], 128, 2)
        pos_np = (full + np.arange(jp) % 128
                  + gen.uniform(-2, rung + 2, (n, lines, jp)))
        base_r = torch.from_numpy(base_np.astype(np.int32)).to(device)
        pos_r = torch.from_numpy(pos_np.astype(np.float32)).to(device)
        err, _ = check_exact(
            f'banded_line_resample taps={rung}',
            lambda: K.banded_line_resample(xb, base_r, pos_r, rung, 255.0),
            lambda: K.banded_line_resample_plain(xb, base_r, pos_r, rung,
                                                 255.0),
            tol=1e-3)
        results['banded_line_resample']['max_abs_err'] = max(
            results['banded_line_resample']['max_abs_err'], err)
        log(f'    banded_line_resample taps={rung}: max_abs_err {err}')
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
    from vkit_tpu_torch.synth import CropConfig, synthesize_stream

    rates = {}
    rng = np.random.default_rng(seed)
    crop_size = side * 4 // 5
    crop = CropConfig(core_size=crop_size, num_per_page=2)
    sync(device)
    begin = time.perf_counter()
    pages = crops = 0
    for result in synthesize_stream(planner, batch, 5, rng, num_batches=3,
                                    crop_config=crop, keep_on_device=True,
                                    device=device):
        check_synth(result, batch, side, crop_size)
        pages += result.images.shape[0]
        crops += result.num_crops
    sync(device)
    rates['synth_pages_per_s'] = pages / (time.perf_counter() - begin)
    rates['synth_crops'] = crops

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
                batches: int = 3, batch: int = 8):
    """Per-stage seconds of synthesize_page_batch (its own timer spans,
    each closed by a device synchronize) over 8-page 640 x 640 batches,
    level 5, two 512 x 512 crops per page, after one batch untimed.
    Returns {stage: mean seconds per batch}."""
    from vkit_tpu_torch.host import StepTimer
    from vkit_tpu_torch.synth import CropConfig, synthesize_page_batch

    rng = np.random.default_rng(seed)
    crop_size = side * 4 // 5
    crop = CropConfig(core_size=crop_size, num_per_page=2)
    page_sets = [planner.prepare_batch(batch, rng)
                 for _ in range(batches + 1)]
    timer = StepTimer()
    for idx, pages in enumerate(page_sets):
        result = synthesize_page_batch(
            pages, 5, rng, crop_config=crop, keep_on_device=True,
            device=device, timer=timer if idx else None,
        )
        check_synth(result, batch, side, crop_size)
    check(timer.counts['photometric'] == batches,
          'the photometric span did not run')
    return {name: timer.totals[name] / batches for name in timer.totals}


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

    device = torch.device('cuda', 0)
    # float32 products (the node upsamples) in full precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()

    # 1. Environment.
    libs = probe_host_libraries()
    font = find_font()
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

    # 3. Kernels against their plain versions, K1 and K3 at the arguments
    # of their first launch in a synth-640 batch.
    assets = build_assets(font)
    planner = make_planner(assets, 640)
    captured, per_batch = capture_main_path_args(device, planner)
    log(f'[3 capture] launches in one synth-640 batch (8 pages, level 5): '
        f'row_shift_window_slab {per_batch["row_shift_window_slab"]}, '
        f'banded_line_resample {per_batch["banded_line_resample"]}')
    kernels = kernel_phase(device, captured)
    del captured
    for name, res in kernels.items():
        log(f'[3 kernel] {name} at {res["shape"]}: max_abs_err '
            f'{res["max_abs_err"]} bit_exact {res["bit_exact"]} ms '
            f'{res["ms"]:.4f} plain_ms {res["plain_ms"]:.4f} library_ms '
            + (f'{res["library_ms"]:.4f}' if res['library_ms'] is not None
               else f'none ({K3_NO_LIBRARY})')
            + f' | bound {res["bound_ms"]:.4f} ms by {res["bound_by"]} '
            f'({res["bytes"] / 1e6:.1f} MB, {res["operations"]:.3g} ops), '
            f'share {res["share"]:.3f} | {card}')

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
    photo_err = photometric_agreement(device, small)
    log(f'[4 main path] synthesize_stream {rates["synth_pages_per_s"]} '
        f'pages/s (3 batches of 8, {rates["synth_crops"]} crops, '
        f'photometric stage on), batch_random_geometric_distort '
        f'{rates["distort_images_per_s"]} images/s, spread split '
        f'{rates["spread_pages_per_s"]} pages/s | launches {launches} '
        f'| card vs CPU: {img_err} LSB, labels {lab_err}, deterministic '
        f'photometric stage {photo_err} LSB | {card}')
    spans = stage_spans(device, planner, seed=200)
    log('[4 stages] synthesize_page_batch s per 8-page batch (timer spans, '
        'mean of 3): ' + ', '.join(f'{name} {sec}'
                                   for name, sec in spans.items())
        + f' | sum {sum(spans.values())} | {card}')
    log(f'[4 photometric] {spans["photometric"]} s per 8-page batch '
        f'(synth-640, level 5), {spans["photometric"] / sum(spans.values())}'
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

    print(json.dumps({'kernels': [
        {
            'name': name, 'route': 'cuda',
            'source': KERNEL_SOURCES[name][0],
            'replaces': KERNEL_SOURCES[name][1],
            'launches': launches[name],
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
