#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vkit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (plus detail lines):
  1. environment: torch / CUDA versions, the card's name and power limit,
     the host libraries the shared host layers need, the font, and the
     native geometry library;
  2. build: nvcc builds the CUDA kernels from vkit_tpu_torch/ops/csrc;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it (max abs difference, median
     CUDA-event time of both);
  4. main path: full-content 640x640 pages through synthesize_stream
     (batch 8, level 5, two 512x512 crops per page), the random geometric
     distortion of 32 x 640x640 x 5 channels, and two-page spreads
     (640 x 1400) split into deskewed single pages by batched_plan_warp.
     Launch counters are zeroed just before and read just after; every
     kernel must have launched.  Outputs must be finite with the expected
     shapes, and a 320x320 batch on the card must agree with the same
     batch through the plain versions on the CPU.
Then one JSON line of per-kernel results, and last
{"ok": true, "device": {...}}.  Any failure raises (exit code != 0).
The script needs a CUDA card and the rest of the repository beside it.
"""
import importlib.metadata
import importlib.util
import json
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
}


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
    for module, dist in (('jax', 'jax'), ('PIL', 'pillow'),
                         ('attr', 'attrs'), ('scipy', 'scipy')):
        check(importlib.util.find_spec(module) is not None,
              f'host library {module} is missing')
        found[module] = importlib.metadata.version(dist)
    return found


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


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of one call, over ``reps`` calls (after a
    warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel_fn, plain_fn, tol: float):
    """Max abs difference of kernel and plain outputs, and both times,
    measured in turns: plain, kernel, kernel, plain."""
    import torch

    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f'{name}: shape {got.shape} != {ref.shape}')
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    exact = bool(torch.equal(got, ref))
    check(err <= tol, f'{name}: max abs err {err} > {tol}')
    del got, ref
    plain_a = time_ms(plain_fn)
    kern_a = time_ms(kernel_fn)
    kern_b = time_ms(kernel_fn)
    plain_b = time_ms(plain_fn)
    return {
        'max_abs_err': err, 'bit_exact': exact,
        'ms': statistics.mean((kern_a, kern_b)),
        'plain_ms': statistics.mean((plain_a, plain_b)),
    }


def kernel_phase(device):
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

    # K1 at the synth stack's shape: (8, 640, 7, 640) -> 512 per row.
    b, l, c, w, ow = 8, 640, 7, 640, 512
    x = torch.from_numpy(
        gen.random((b, l, c, w), dtype=np.float32) * 255
    ).to(device)
    bound = K.WINDOW - w - ow
    starts = torch.from_numpy(
        gen.integers(-bound, bound + 1, (b, l)).astype(np.int32)
    ).to(device)
    results['row_shift_window_slab'] = compare(
        'row_shift_window_slab',
        lambda: K.row_shift_window_slab(x, starts, ow, 255.0),
        lambda: K.row_shift_window_slab_plain(x, starts, ow, 255.0),
        tol=0.0,
    )
    del x, starts

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
    x = torch.from_numpy(
        gen.random((n, lines, c, m_in), dtype=np.float32) * 255
    ).to(device)
    before = K.LAUNCHES['row_shift']
    out = apply_line_resample(x, plan_t, statics, border_value=255.0)
    torch.cuda.synchronize()
    check(K.LAUNCHES['row_shift'] == before + 1,
          'apply_line_resample did not take the row_shift route')
    check(bool(torch.isfinite(out).all()), 'apply_line_resample not finite')
    del out
    x_p = F.pad(x, (statics.pad_lo, statics.m_padded - m_in - statics.pad_lo),
                value=255.0).reshape(n, lines * c, statics.m_padded)
    rows = plan_t.starts[:, :, None].expand(n, lines, c).reshape(
        n, lines * c).to(torch.int32).contiguous()
    results['row_shift'] = compare(
        'row_shift',
        lambda: K.row_shift(x_p, rows, statics.m_shift),
        lambda: K.row_shift_plain(x_p, rows, statics.m_shift),
        tol=0.0,
    )
    log(f'    row_shift statics: {statics}')
    del x, x_p, rows

    # K3 at (8, 640, 7, 640) -> JP 768, each rung of the tap ladder.
    n, lines, c, w, jp = 8, 640, 7, 640, 768
    x = torch.from_numpy(
        gen.random((n, lines, c, w), dtype=np.float32) * 255
    ).to(device)
    groups = -(-lines // 8)
    per_taps = {}
    for taps in (32, 64, 128):
        base_np = gen.integers(-500, 1281, (n, groups, jp // 128))
        full = np.repeat(np.repeat(base_np, 8, 1)[:, :lines], 128, 2)
        pos_np = (full + np.arange(jp) % 128
                  + gen.uniform(-2, taps + 2, (n, lines, jp)))
        base = torch.from_numpy(base_np.astype(np.int32)).to(device)
        pos = torch.from_numpy(pos_np.astype(np.float32)).to(device)
        per_taps[taps] = compare(
            f'banded_line_resample taps={taps}',
            lambda: K.banded_line_resample(x, base, pos, taps, 255.0),
            lambda: K.banded_line_resample_plain(x, base, pos, taps, 255.0),
            tol=1e-3,
        )
        log(f'    banded_line_resample taps={taps}: {per_taps[taps]}')
    results['banded_line_resample'] = {
        'max_abs_err': max(r['max_abs_err'] for r in per_taps.values()),
        'bit_exact': all(r['bit_exact'] for r in per_taps.values()),
        'ms': per_taps[128]['ms'],
        'plain_ms': per_taps[128]['plain_ms'],
    }
    del x
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


def main_path(device, planner, seed: int, side: int = 640, batch: int = 8,
              distort_batch: int = 32, spread_height: int = 640):
    """One run of the main path; returns its rates."""
    import torch

    from vkit_tpu_torch.mechanism.batched import batched_plan_warp
    from vkit_tpu_torch.mechanism.batched_random import (
        batch_random_geometric_distort,
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

    gen = np.random.default_rng(seed + 1)
    shape = (distort_batch, side, side)
    stack = torch.cat([
        torch.from_numpy(
            gen.integers(0, 256, shape + (3,), dtype=np.uint8)
        ).to(device).to(torch.float32),
        torch.from_numpy(
            (gen.random(shape + (2,)) > 0.5).astype(np.float32)
        ).to(device),
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
    del stack, warped

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


def small_batch_agreement(device, planner):
    """A 320x320 batch through the kernels on the card and through the
    plain versions on the CPU: same masks, images within 1 LSB and labels
    within 1e-2 inside the active masks."""
    from vkit_tpu_torch.synth import CropConfig, synthesize_page_batch

    pages = planner.prepare_batch(2, np.random.default_rng(21))
    crop = CropConfig(core_size=192, num_per_page=2)
    card = synthesize_page_batch(pages, 5, np.random.default_rng(22),
                                 crop_config=crop, device=device)
    host = synthesize_page_batch(pages, 5, np.random.default_rng(22),
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
    import vkit_tpu_torch  # noqa: F401 - pins jax to the CPU first
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
        f'| allow_tf32 {torch.backends.cuda.matmul.allow_tf32}')

    # 2. Build.
    begin = time.perf_counter()
    lib_path = K.library_path()
    K.load_library()
    log(f'[2 build] {lib_path.name}: nvcc {K.BUILD_SECONDS} s, '
        f'load {time.perf_counter() - begin:.3f} s')

    # 3. Kernels against their plain versions.
    kernels = kernel_phase(device)
    for name, res in kernels.items():
        log(f'[3 kernel] {name}: max_abs_err {res["max_abs_err"]} '
            f'bit_exact {res["bit_exact"]} ms {res["ms"]:.4f} '
            f'plain_ms {res["plain_ms"]:.4f} | {card}')

    # 4. Main path.
    assets = build_assets(font)
    planner = make_planner(assets, 640)
    main_path(device, planner, seed=100)           # warm-up, not counted
    launches = rates = None
    for seed in range(101, 106):
        K.reset_launch_counts()
        rates = main_path(device, planner, seed)
        launches = dict(K.LAUNCHES)
        if all(launches.values()):
            break
        log(f'    seed {seed}: launches {launches}; drawing another seed')
    check(all(launches.values()), f'a kernel never launched: {launches}')
    small = make_planner(assets, 320)
    img_err, lab_err = small_batch_agreement(device, small)
    log(f'[4 main path] synthesize_stream {rates["synth_pages_per_s"]:.3f} '
        f'pages/s ({rates["synth_crops"]} crops), '
        f'batch_random_geometric_distort '
        f'{rates["distort_images_per_s"]:.3f} images/s, spread split '
        f'{rates["spread_pages_per_s"]:.3f} pages/s | launches {launches} '
        f'| card vs CPU: {img_err} LSB, labels {lab_err} | {card}')

    print(json.dumps({'kernels': [
        {
            'name': name, 'route': 'cuda',
            'source': KERNEL_SOURCES[name][0],
            'replaces': KERNEL_SOURCES[name][1],
            'launches': launches[name],
            'max_abs_err': res['max_abs_err'],
            'ms': res['ms'], 'plain_ms': res['plain_ms'],
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
