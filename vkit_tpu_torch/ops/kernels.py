"""Hand-written Hopper kernels of the port, their wrappers and plain twins.

Four CUDA kernels replace the Pallas kernels of
vkit_tpu/ops/pallas_kernels.py:

  row_shift_window_slab  (csrc/row_shift.cu)        <- row_shift_window_slab
  row_shift              (csrc/row_shift.cu)        <- row_shift
  banded_line_resample   (csrc/banded_resample.cu)  <- banded_line_resample
  row_shift_window       (csrc/row_shift.cu)        <- row_shift_window

and two more do the two-shear warp's work around its row shifts, which the
JAX package leaves to XLA:

  quadrant_slab          (csrc/two_shear.cu)  <- jnp.rot90 / jnp.where of
                                                  apply_affine_warp_quad and
                                                  the transpose before pass V
  line_blend             (csrc/two_shear.cu)  <- apply_line_resample's one-hot
                                                  einsum and weighted sum and
                                                  the transposes after it

Which path launches which: the two-shear affine warp (ops/warp_mxu.py
``apply_affine_warp`` and ``apply_affine_warp_quad``) launches
``quadrant_slab`` once, then per pass ``row_shift_window_slab``, or
``row_shift`` where a pass's span fails the 2048-lane window (a 1400-lane
spread cut to 700), and ``line_blend`` after it (``apply_line_resample``
launches the last two alone); it serves the page warp of synth/device.py
and RandomDistortion (mechanism/batched.py's affine route), the one-program
chain (parallel/batch.py), the train step's label warp (entry.py), the
text-region stream's flatten (ops/region.py, per flatten chunk), and step
15 of the text-detection pipeline (pipeline/text_detection/
page_text_region.py, per source-tile bucket of its flatten).  The dense
two-pass (``apply_dense_warp``) launches the row shifts alone.  The banded
two-pass warp (ops/warp_banded.py) launches ``banded_line_resample`` once
per pass for smooth fields.  ``row_shift_window`` (K1 with one channel) has
no caller on a path, in the JAX package or here.

The sources build at first use with ``nvcc`` (one process per source, all
started together, then one link) into one shared library with a plain C
interface under ``ops/build/`` (named by a hash of the sources and flags,
so an edit rebuilds; nvcc's ``-Xptxas -v`` report is kept beside it, see
``build_log``) and load through ctypes.  Nothing builds or
loads while this module is imported: CPU-only installs import it freely.

Every wrapper checks device, dtype, shape, contiguity and the bounds the
JAX wrapper asserts, then:
  - a CPU tensor goes to the plain PyTorch version of the kernel below
    (the CPU tests use it);
  - a CUDA tensor launches the kernel on the current stream, or raises.
    There is no fallback from a CUDA tensor to the plain version.
``LAUNCHES`` counts kernel launches per wrapper (plain calls do not count).
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..convert import DeviceError

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / 'csrc'
_BUILD = _HERE / 'build'
_SOURCES = ('row_shift.cu', 'banded_resample.cu', 'two_shear.cu')
_HEADERS = ('tma.cuh',)
_NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

# The TPU kernels' window: rows are rolled inside 2048 lanes.
WINDOW = 2048
# K2's roll window and its largest output (pallas_kernels._ROLL_WINDOW).
ROLL_WINDOW = 1024
# K3 places each source row at this lane of the window.
ROW_OFFSET = 512

LAUNCHES = {
    'row_shift_window_slab': 0,
    'row_shift': 0,
    'banded_line_resample': 0,
    'row_shift_window': 0,
    'quadrant_slab': 0,
    'line_blend': 0,
}

_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None  # wall time of the last nvcc build in this process


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise DeviceError('nvcc not found: the CUDA kernels cannot be built')


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        digest.update((_CSRC / name).read_bytes())
    digest.update(' '.join(_NVCC_FLAGS).encode())
    return _BUILD / f'libvkit_kernels_{digest.hexdigest()[:16]}.so'


def build_log() -> str:
    """nvcc's output for the current library (``-Xptxas -v``: registers,
    shared memory and spills of each kernel), kept beside it at build."""
    path = library_path().with_suffix('.log')
    return path.read_text() if path.exists() else ''


def _build(target: Path):
    """One nvcc per source, all started together, then one link."""
    global BUILD_SECONDS
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    objects = [tmp.with_suffix(f'.{Path(name).stem}.o') for name in _SOURCES]
    begin = time.perf_counter()
    procs = [
        subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, '-c', '-o', str(obj), str(_CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(_SOURCES, objects)
    ]
    log = ''.join(f'== {name}\n{proc.communicate()[0]}'
                  for name, proc in zip(_SOURCES, procs))
    try:
        if any(proc.returncode for proc in procs):
            raise DeviceError(f'nvcc failed:\n{log}')
        link = subprocess.run(
            [_nvcc(), '-shared', '-o', str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise DeviceError(f'nvcc link failed:\n{link.stdout}')
        target.with_suffix('.log').write_text(log)
        os.replace(tmp, target)
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    BUILD_SECONDS = time.perf_counter() - begin


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as error:
            raise DeviceError(f'cannot load {target}: {error}') from error
        ptr, i32, i64, f32 = (
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        )
        lib.vk_row_shift_window_slab.argtypes = [
            ptr, ptr, ptr, i64, i32, i32, i32, f32, ptr,
        ]
        lib.vk_row_shift_window_slab.restype = i32
        lib.vk_row_shift.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.vk_row_shift.restype = i32
        lib.vk_banded_line_resample.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, f32,
            i32, i32, i32, i32, i32, ptr,
        ]
        lib.vk_banded_line_resample.restype = i32
        lib.vk_row_shift_window.argtypes = [
            ptr, ptr, ptr, i64, i32, i32, f32, ptr,
        ]
        lib.vk_row_shift_window.restype = i32
        lib.vk_quadrant_slab.argtypes = [
            ptr, i32, ptr, ptr, i64, i32, i32, i32, ptr,
        ]
        lib.vk_quadrant_slab.restype = i32
        lib.vk_line_blend.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, ptr,
        ]
        lib.vk_line_blend.restype = i32
        _lib = lib
        return lib


def _check_launch(name: str, code: int):
    if code != 0:
        raise DeviceError(
            f'{name}: kernel launch failed with cudaError {code}'
        )
    LAUNCHES[name] += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _check_tensor(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name} must be a torch.Tensor, got {type(t)}')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if t.dim() != ndim:
        raise ValueError(f'{name} must be {ndim}-D, got {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


# ---------------------------------------------------------------------------
# K1: row_shift_window_slab.
# ---------------------------------------------------------------------------


def row_shift_window_slab_plain(x, starts, out_width: int,
                                border_value: float = 0.0):
    """Plain twin of K1: the TPU kernel's mod-2048 window, gathered."""
    in_width = x.shape[-1]
    j = torch.arange(out_width, device=x.device, dtype=torch.int64)
    k = torch.remainder(starts.to(torch.int64)[..., None] + j, WINDOW)
    inside = k < in_width                                  # (B, L, out_w)
    idx = k.clamp(max=in_width - 1)[:, :, None, :].expand(
        -1, -1, x.shape[2], -1
    )
    vals = torch.gather(x, 3, idx)
    border = torch.full((), border_value, dtype=x.dtype, device=x.device)
    return torch.where(inside[:, :, None, :], vals, border)


def row_shift_window_slab(x, starts, out_width: int,
                          border_value: float = 0.0):
    """``out[b, l, c, j] = x[b, l, c, starts[b, l] + j]``; positions outside
    ``[0, W)`` read ``border_value``.

    ``x``: (B, L, C, W) float32; ``starts``: (B, L) int32.  Like the TPU
    kernel, needs ``W + out_width <= 2048`` (the window is 2048 lanes and
    indices wrap mod 2048; starts within +-(2048 - W - out_width) never
    wrap into the row)."""
    _check_tensor('x', x, torch.float32, 4, x.device)
    _check_tensor('starts', starts, torch.int32, 2, x.device)
    b, l, c, in_width = x.shape
    if tuple(starts.shape) != (b, l):
        raise ValueError(f'starts {tuple(starts.shape)} != {(b, l)}')
    if out_width < 1 or in_width + out_width > WINDOW:
        raise ValueError(
            f'in_width {in_width} + out_width {out_width} exceeds {WINDOW}'
        )
    if x.device.type == 'cpu':
        return row_shift_window_slab_plain(x, starts, out_width, border_value)
    out = torch.empty((b, l, c, out_width), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    code = lib.vk_row_shift_window_slab(
        _ptr(x), _ptr(starts), _ptr(out), b * l, c, in_width, out_width,
        float(border_value), _stream(),
    )
    _check_launch('row_shift_window_slab', code)
    return out


# ---------------------------------------------------------------------------
# K4: row_shift_window (K1 with one channel).
# ---------------------------------------------------------------------------


def row_shift_window_plain(x, starts, out_width: int,
                           border_value: float = 0.0):
    """Plain twin of K4."""
    return row_shift_window_slab_plain(
        x[:, :, None, :], starts, out_width, border_value
    )[:, :, 0, :]


def row_shift_window(x, starts, out_width: int, border_value: float = 0.0):
    """``out[b, l, j] = x[b, l, starts[b, l] + j]``; positions outside
    ``[0, W)`` read ``border_value``.

    ``x``: (B, L, W) float32; ``starts``: (B, L) int32.  As for the TPU
    kernel, needs ``W + out_width <= 2048`` (indices wrap mod 2048)."""
    _check_tensor('x', x, torch.float32, 3, x.device)
    _check_tensor('starts', starts, torch.int32, 2, x.device)
    b, l, in_width = x.shape
    if tuple(starts.shape) != (b, l):
        raise ValueError(f'starts {tuple(starts.shape)} != {(b, l)}')
    if out_width < 1 or in_width + out_width > WINDOW:
        raise ValueError(
            f'in_width {in_width} + out_width {out_width} exceeds {WINDOW}'
        )
    if x.device.type == 'cpu':
        return row_shift_window_plain(x, starts, out_width, border_value)
    out = torch.empty((b, l, out_width), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    code = lib.vk_row_shift_window(
        _ptr(x), _ptr(starts), _ptr(out), b * l, in_width, out_width,
        float(border_value), _stream(),
    )
    _check_launch('row_shift_window', code)
    return out


# ---------------------------------------------------------------------------
# K2: row_shift (caller-padded rows).
# ---------------------------------------------------------------------------


def row_shift_plain(x_padded, starts, out_width: int):
    """Plain twin of K2 (indices clamped into the padded row)."""
    m_padded = x_padded.shape[-1]
    j = torch.arange(out_width, device=x_padded.device, dtype=torch.int64)
    idx = (starts.to(torch.int64)[..., None] + j).clamp(0, m_padded - 1)
    return torch.gather(x_padded, 2, idx)


def row_shift(x_padded, starts, out_width: int):
    """``out[b, l, j] = x_padded[b, l, starts[b, l] + j]``.

    ``x_padded``: (B, L, Mpad) float32 with ``Mpad >= 1024``; ``starts``:
    (B, L) int32.  As for the TPU kernel, ``out_width <= 896`` and the
    caller keeps ``0 <= starts`` and ``starts + 1024 <= Mpad``."""
    _check_tensor('x_padded', x_padded, torch.float32, 3, x_padded.device)
    _check_tensor('starts', starts, torch.int32, 2, x_padded.device)
    b, l, m_padded = x_padded.shape
    if tuple(starts.shape) != (b, l):
        raise ValueError(f'starts {tuple(starts.shape)} != {(b, l)}')
    if not 1 <= out_width <= ROLL_WINDOW - 128:
        raise ValueError(f'out_width {out_width} outside [1, 896]')
    if m_padded < ROLL_WINDOW:
        raise ValueError(f'padded width {m_padded} < {ROLL_WINDOW}')
    if x_padded.device.type == 'cpu':
        return row_shift_plain(x_padded, starts, out_width)
    out = torch.empty((b, l, out_width), dtype=x_padded.dtype,
                      device=x_padded.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    code = lib.vk_row_shift(
        _ptr(x_padded), _ptr(starts), _ptr(out), b * l, m_padded, out_width,
        _stream(),
    )
    _check_launch('row_shift', code)
    return out


# ---------------------------------------------------------------------------
# K3: banded_line_resample.
# ---------------------------------------------------------------------------


def _window_taps(x, k, border_value):
    """Values of the 2048-lane window (row at lane 512, border elsewhere,
    lane index mod 2048) at source index ``k`` (N, L, JP) for every
    channel -> (N, L, C, JP)."""
    in_width = x.shape[-1]
    col = torch.remainder(k + ROW_OFFSET, WINDOW) - ROW_OFFSET
    inside = (col >= 0) & (col < in_width)
    idx = col.clamp(0, in_width - 1)[:, :, None, :].expand(
        -1, -1, x.shape[2], -1
    )
    vals = torch.gather(x, 3, idx)
    border = torch.full((), border_value, dtype=x.dtype, device=x.device)
    return torch.where(inside[:, :, None, :], vals, border)


def banded_line_resample_plain(x, base, pos, taps: int,
                               border_value: float = 0.0):
    """Plain twin of K3: the two taps floor(u), floor(u) + 1 that carry
    weight, each masked to [0, taps) and read through the window."""
    n, l, c, in_width = x.shape
    jp = pos.shape[-1]
    j = torch.arange(jp, device=x.device)
    lane = (j % 128).to(torch.float32)
    b = base.repeat_interleave(8, dim=1)[:, :l]            # (N, L, JP/128)
    b = b.repeat_interleave(128, dim=2)                    # (N, L, JP)
    u = pos - (b.to(torch.float32) + lane)
    t0f = torch.floor(u)
    t0 = t0f.to(torch.int64)
    w0 = torch.clamp(1.0 - torch.abs(u - t0f), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(u - (t0f + 1.0)), min=0.0)
    w0 = torch.where((t0 >= 0) & (t0 < taps), w0, 0.0)
    w1 = torch.where((t0 + 1 >= 0) & (t0 + 1 < taps), w1, 0.0)
    k0 = b.to(torch.int64) + (j % 128) + t0
    v0 = _window_taps(x, k0, border_value)
    v1 = _window_taps(x, k0 + 1, border_value)
    return w0[:, :, None, :] * v0 + w1[:, :, None, :] * v1


# K3's launch: 256 threads a block, at most 4 blocks an SM (its
# __launch_bounds__), two stages of at most ~36 KB each.
K3_BLOCKS_PER_SM = 4
K3_STAGE_BYTES = 36 * 1024
K3_HEADER_BYTES = 128
# Hopper's shared memory: the most a block may opt in to (227 KB) and an
# SM's (228 KB, of which each resident block also takes 1 KB).
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472


class BandedLaunch(NamedTuple):
    lines_per_item: int   # G: lines of one 8-line base group per item
    chunk: int            # channels per item
    chunks: int
    items: int            # N * ceil(L / G) * chunks
    stage_floats: int     # floats of one stage, a multiple of 4
    smem_bytes: int       # dynamic shared memory of a block
    blocks_per_sm: int
    grid: int             # persistent blocks


@functools.lru_cache(maxsize=256)
def banded_launch(n: int, lines: int, channels: int, width: int, sms: int):
    """K3's launch parameters for x (n, lines, channels, width) on a card
    with ``sms`` SMs: the most lines per item (1, 2, 4 or 8, so an item
    never crosses an 8-line base group) whose source fits a stage of
    K3_STAGE_BYTES; a line that does not fit is split into channel chunks
    that do.  A stage holds the item's floats at their 16-byte phase (up
    to 3 floats ahead)."""
    line_bytes = 4 * channels * width
    if line_bytes <= K3_STAGE_BYTES:
        lines_per_item = max(g for g in (1, 2, 4, 8)
                             if g * line_bytes <= K3_STAGE_BYTES)
        chunk = channels
    else:
        lines_per_item = 1
        chunk = max(1, K3_STAGE_BYTES // (4 * width))
    chunks = -(-channels // chunk)
    items = n * -(-lines // lines_per_item) * chunks
    stage_floats = -(-(lines_per_item * chunk * width + 3) // 4) * 4
    smem_bytes = K3_HEADER_BYTES + 2 * 4 * stage_floats
    if smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(f'K3 stage of {stage_floats} floats exceeds shared '
                         'memory')
    blocks_per_sm = min(K3_BLOCKS_PER_SM, SMEM_PER_SM // (smem_bytes + 1024))
    grid = max(1, min(items, blocks_per_sm * sms))
    if items + grid >= 2**31 or n * lines >= 2**31:
        raise ValueError(f'{items} K3 items exceed int32')
    return BandedLaunch(lines_per_item, chunk, chunks, items, stage_floats,
                        smem_bytes, blocks_per_sm, grid)


def banded_item(launch: BandedLaunch, lines: int, channels: int, item: int):
    """(n, first line, lines, first channel, channels) of K3's work item
    ``item``: the kernel's decompose() (csrc/banded_resample.cu)."""
    per_sample = -(-lines // launch.lines_per_item) * launch.chunks
    n, rest = divmod(item, per_sample)
    group, chunk = divmod(rest, launch.chunks)
    l0 = group * launch.lines_per_item
    c0 = chunk * launch.chunk
    return (n, l0, min(launch.lines_per_item, lines - l0), c0,
            min(launch.chunk, channels - c0))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def banded_line_resample(x, base, pos, taps: int,
                         border_value: float = 0.0):
    """``out[n, l, c, j] = interp(x[n, l, c, :], at=pos[n, l, j])``.

    ``x``: (N, L, C, W) float32 with ``W + 384 <= 2048``; ``base``:
    (N, ceil(L/8), JP/128) int32, one integer base per 8-line group and
    128-lane block; ``pos``: (N, L, JP) float32, JP a multiple of 128;
    ``taps <= 128``.  Same contract as the TPU kernel (see
    csrc/banded_resample.cu)."""
    _check_tensor('x', x, torch.float32, 4, x.device)
    _check_tensor('base', base, torch.int32, 3, x.device)
    _check_tensor('pos', pos, torch.float32, 3, x.device)
    n, l, c, in_width = x.shape
    jp = pos.shape[-1]
    if tuple(pos.shape) != (n, l, jp) or jp % 128:
        raise ValueError(f'pos {tuple(pos.shape)} does not fit x {x.shape}')
    groups = -(-l // 8)
    if tuple(base.shape) != (n, groups, jp // 128):
        raise ValueError(
            f'base {tuple(base.shape)} != {(n, groups, jp // 128)}'
        )
    if not 1 <= taps <= 128:
        raise ValueError(f'taps {taps} outside [1, 128]')
    if in_width + 128 + 256 > WINDOW:
        raise ValueError(f'in_width {in_width} too wide for the window')
    if x.device.type == 'cpu':
        return banded_line_resample_plain(x, base, pos, taps, border_value)
    out = torch.empty((n, l, c, jp), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    launch = banded_launch(n, l, c, in_width, _sm_count(x.device.index))
    lib = load_library()
    code = lib.vk_banded_line_resample(
        _ptr(x), _ptr(base), _ptr(pos), _ptr(out), n, l, c, in_width, jp,
        groups, taps, float(border_value), launch.lines_per_item,
        launch.chunk, launch.stage_floats, launch.smem_bytes, launch.grid,
        _stream(),
    )
    _check_launch('banded_line_resample', code)
    return out


# ---------------------------------------------------------------------------
# The two-shear warp's slab and blend (csrc/two_shear.cu).
# ---------------------------------------------------------------------------


def rot90_samples(images, quadrants):
    """Per-sample ``np.rot90(image, k, axes=(1, 2))`` with k from
    ``quadrants`` (host (N,) ints).  k in {1, 3} needs a square image."""
    quadrants = np.asarray(quadrants)
    out = images
    for k in (1, 2, 3):
        sel = np.flatnonzero(quadrants == k)
        if len(sel) == 0:
            continue
        if out is images:
            out = images.clone()
        idx = torch.as_tensor(sel, device=images.device)
        out[idx] = torch.rot90(images[idx], k, (1, 2))
    return out


def quadrant_slab_plain(images, quadrants=None):
    """Plain twin of ``quadrant_slab``: ``rot90_samples``, the cast to
    float32 and the transpose to pass V's slab."""
    if quadrants is not None:
        images = rot90_samples(images, quadrants)
    return images.to(torch.float32).permute(0, 2, 3, 1).contiguous()


def quadrant_slab(images, quadrants=None):
    """Pass V's slab of the two-shear warp: ``out[n, u, c, y] =
    rot90(images[n], k)[y, u, c]`` as float32, k = ``quadrants[n]``
    (``np.rot90`` on axes (1, 2)).

    ``images``: (N, H, W, C) uint8 or float32; ``quadrants``: None (every
    k 0) or host (N,) ints in 0..3, where 1 and 3 need ``H == W``.
    Returns (N, W, C, H) float32."""
    if not isinstance(images, torch.Tensor):
        raise TypeError(f'images must be a torch.Tensor, got {type(images)}')
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f'images must be uint8 or float32, got {images.dtype}')
    _check_tensor('images', images, images.dtype, 4, images.device)
    n, h, w, c = images.shape
    if quadrants is not None:
        quadrants = np.asarray(quadrants)
        if quadrants.shape != (n,) or quadrants.dtype.kind not in 'iu':
            raise ValueError(f'quadrants must be ({n},) ints, got '
                             f'{quadrants.dtype} {quadrants.shape}')
        if ((quadrants < 0) | (quadrants > 3)).any():
            raise ValueError('quadrants must lie in 0..3')
        if h != w and (quadrants % 2 == 1).any():
            raise ValueError(f'quadrants 1 and 3 need a square image, got '
                             f'{h} x {w}')
        if not quadrants.any():
            quadrants = None
    if images.device.type == 'cpu':
        return quadrant_slab_plain(images, quadrants)
    out = torch.empty((n, w, c, h), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    quads = (None if quadrants is None else
             torch.from_numpy(quadrants.astype(np.int32)).to(images.device))
    lib = load_library()
    code = lib.vk_quadrant_slab(
        _ptr(images), int(images.dtype == torch.uint8),
        None if quads is None else _ptr(quads), _ptr(out), n, h, w, c,
        _stream(),
    )
    _check_launch('quadrant_slab', code)
    return out


# The blend's output layouts: the order of (N, L, C, J)'s axes in memory.
LINE_BLEND_LAYOUTS = {
    'nlcj': (0, 1, 2, 3),   # apply_line_resample's own output
    'njcl': (0, 3, 2, 1),   # pass V's output as pass H's slab
    'nljc': (0, 1, 3, 2),   # pass H's output as (N, H_out, W_out, C)
}


def line_blend_plain(window, i0, frac_j, phi, layout: str = 'nlcj'):
    """Plain twin of ``line_blend``: the 3-tap gather at i0 + {0, 1, 2} and
    the hat blend (the reference's one-hot einsum + weighted sum, same
    summation order), then the layout's copy."""
    n, l, c, _ = window.shape
    jn = i0.shape[1]
    idx = i0.to(torch.int64)[:, None, None, :].expand(n, l, c, jn)
    a0 = torch.gather(window, 3, idx)
    a1 = torch.gather(window[..., 1:], 3, idx)
    a2 = torch.gather(window[..., 2:], 3, idx)

    u = frac_j[:, None, :] + phi[:, :, None]               # (N, L, J)
    w0 = torch.clamp(1.0 - u, min=0.0)
    w2 = torch.clamp(u - 1.0, min=0.0)
    w1 = 1.0 - w0 - w2
    w0, w1, w2 = (w[:, :, None, :] for w in (w0, w1, w2))
    out = a0 * w0 + a1 * w1 + a2 * w2                       # (N, L, C, J)
    return out.permute(*LINE_BLEND_LAYOUTS[layout]).contiguous()


def line_blend(window, i0, frac_j, phi, layout: str = 'nlcj'):
    """``out[n, l, c, j] = a0 * w0 + a1 * w1 + a2 * w2`` with ``a_t =
    window[n, l, c, i0[n, j] + t]`` and the hat weights of ``u = frac_j[n,
    j] + phi[n, l]``: ``w0 = max(1 - u, 0)``, ``w2 = max(u - 1, 0)``, ``w1
    = 1 - w0 - w2``.

    ``window``: (N, L, C, M) float32, M >= 3 (a row-shift kernel's
    output); ``i0``: (N, J) int32 in [0, M - 3]; ``frac_j``: (N, J) and
    ``phi``: (N, L) float32.  ``layout`` orders the output's axes in memory
    (LINE_BLEND_LAYOUTS): 'nlcj' (N, L, C, J), 'njcl' (N, J, C, L) or
    'nljc' (N, L, J, C)."""
    _check_tensor('window', window, torch.float32, 4, window.device)
    _check_tensor('i0', i0, torch.int32, 2, window.device)
    _check_tensor('frac_j', frac_j, torch.float32, 2, window.device)
    _check_tensor('phi', phi, torch.float32, 2, window.device)
    n, l, c, m = window.shape
    jn = i0.shape[1]
    if tuple(i0.shape) != (n, jn) or tuple(frac_j.shape) != (n, jn):
        raise ValueError(f'i0 {tuple(i0.shape)} and frac_j '
                         f'{tuple(frac_j.shape)} must be ({n}, J)')
    if tuple(phi.shape) != (n, l):
        raise ValueError(f'phi {tuple(phi.shape)} != {(n, l)}')
    if m < 3:
        raise ValueError(f'window width {m} < 3 taps')
    if layout not in LINE_BLEND_LAYOUTS:
        raise ValueError(f'unknown layout {layout!r}')
    if window.device.type == 'cpu':
        return line_blend_plain(window, i0, frac_j, phi, layout)
    dims = (n, l, c, jn)
    out = torch.empty([dims[d] for d in LINE_BLEND_LAYOUTS[layout]],
                      dtype=torch.float32, device=window.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    code = lib.vk_line_blend(
        _ptr(window), _ptr(i0), _ptr(frac_j), _ptr(phi), _ptr(out), n, l, c,
        m, jn, list(LINE_BLEND_LAYOUTS).index(layout), _stream(),
    )
    _check_launch('line_blend', code)
    return out
