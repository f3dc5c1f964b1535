"""The port's kernel layer (vkit_tpu_torch/ops/kernels.py) against the Pallas
kernels of vkit_tpu/ops/pallas_kernels.py, which run here in interpret
mode.  On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels themselves are compared with those on the card (``cuda_device``
tests, skipped without one)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkit_tpu.ops import pallas_kernels as PK
from vkit_tpu_torch import convert
from vkit_tpu_torch.ops import kernels as K
from vkit_tpu_torch.ops import warp_mxu

from tests import two_shear_cases as TS

torch.set_num_threads(1)

PORT_ROOT = Path(__file__).resolve().parents[1] / 'vkit_tpu_torch'


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _slab_case(seed, b=2, l=24, c=3, w=200, ow=160):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, l, c, w), dtype=np.float32) * 255).astype(np.float32)
    bound = K.WINDOW - w - ow
    starts = rng.integers(-bound, bound + 1, (b, l)).astype(np.int32)
    starts[0, :8] = rng.integers(-60, w, 8)     # partly inside the row
    return x, starts, ow


def _slab_starts(kind, rng, b, l, w, ow):
    """K1 starts of one kind: the main path's (each window on the row's
    content, a few lanes over either edge), windows that wrap mod 2048 back
    into the row, or any int32."""
    if kind == 'main_path':
        return rng.integers(-24, w - ow + 24, (b, l)).astype(np.int32)
    if kind == 'wrap':
        lap = rng.integers(-3, 4, (b, l)) * K.WINDOW
        return (lap + rng.integers(K.WINDOW - ow, K.WINDOW + w, (b, l))
                ).astype(np.int32)
    return rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        (b, l), dtype=np.int64).astype(np.int32)


# (kind, channels, W, out_w): the main path's 7 channels of 640 -> 512,
# wrapping and arbitrary starts, and widths that are not multiples of 4.
SLAB_CASES = [
    ('main_path', 7, 640, 512),
    ('wrap', 7, 640, 512),
    ('any', 3, 640, 512),
    ('main_path', 5, 637, 509),
    ('wrap', 2, 637, 509),
]


def _slab_kind_case(kind, c, w, ow, seed=0, b=2, l=12):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, l, c, w), dtype=np.float32) * 255).astype(np.float32)
    return x, _slab_starts(kind, rng, b, l, w, ow), ow


def _window_case(seed, b=2, l=40, w=300, ow=256):
    """K4's rows: starts across the whole window, some inside the row."""
    rng = np.random.default_rng(seed)
    x = (rng.random((b, l, w), dtype=np.float32) * 255).astype(np.float32)
    bound = K.WINDOW - w - ow
    starts = rng.integers(-bound, bound + 1, (b, l)).astype(np.int32)
    starts[0, :10] = rng.integers(-40, w, 10)
    return x, starts, ow


def _row_shift_case(seed, b=2, l=20, m=1536, ow=400):
    rng = np.random.default_rng(seed)
    x = rng.random((b, l, m), dtype=np.float32)
    starts = rng.integers(0, m - K.ROLL_WINDOW, (b, l)).astype(np.int32)
    return x, starts, ow


# K2 cases: (name, Mpad, out_w, kind of starts).  Odd and even widths that
# are no multiple of 4, the widest output, the narrowest padded row with
# start 0, and starts outside the caller's contract, which clamp each index
# into the row.
ROW_SHIFT_CASES = [
    ('odd_width', 1536, 401, 'contract'),
    ('even_not_quad', 1792, 702, 'contract'),
    ('widest', 1536, 896, 'contract'),
    ('narrow_pad_start0', 1024, 640, 'zero'),
    ('tiny_width', 1100, 3, 'contract'),
    ('clamped', 1280, 702, 'outside'),
]


def _row_shift_kind_case(m, ow, kind, seed=0, b=3, l=37):
    rng = np.random.default_rng(seed)
    x = rng.random((b, l, m), dtype=np.float32)
    if kind == 'zero':
        starts = np.zeros((b, l), np.int32)
    elif kind == 'contract':
        starts = rng.integers(0, m - K.ROLL_WINDOW + 1, (b, l)).astype(
            np.int32)
        starts[0, 0], starts[-1, -1] = 0, m - K.ROLL_WINDOW
    else:
        starts = rng.integers(-2 * m, 2 * m, (b, l)).astype(np.int32)
        starts[0, :4] = (-1, m - ow + 1, np.iinfo(np.int32).max,
                         np.iinfo(np.int32).min)
        starts[1, :2] = (0, m - ow)        # the last starts that do not clamp
    return x, starts, ow


def _row_shift_numpy(x, starts, ow):
    idx = np.clip(starts.astype(np.int64)[..., None] + np.arange(ow), 0,
                  x.shape[-1] - 1)
    return np.take_along_axis(x, idx, axis=2)


def _banded_case(seed, taps, n=2, l=12, c=3, w=300, jp=256):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, l, c, w), dtype=np.float32) * 255).astype(np.float32)
    base = rng.integers(-520, 1300, (n, -(-l // 8), jp // 128))
    full = np.repeat(np.repeat(base, 8, 1)[:, :l], 128, 2)
    # Positions inside and a little outside the band [0, taps - 2].
    pos = full + np.arange(jp) % 128 + rng.uniform(-2, taps + 2, (n, l, jp))
    return x, base.astype(np.int32), pos.astype(np.float32)


# (N, L, C, W, JP) of every K3 launch on the paths (chip_smoke.py's
# phase-9 line of K3's shapes over phases 4-9: the page warp, the grid
# warps, RandomDistortion, the 320-px checks), and the extremes: one and
# sixteen channels, W of 1, 641 (C * W % 4 != 0) and 1664 (the window's
# widest), L not a multiple of 8.
BANDED_LAUNCH_SHAPES = [
    (1, 320, 7, 320, 384),
    (1, 384, 7, 320, 384),
    (8, 320, 5, 320, 768),
    (8, 320, 7, 320, 640),
    (8, 640, 7, 320, 640),
    (8, 640, 7, 640, 640),
    (8, 768, 5, 320, 768),
    (16, 640, 5, 640, 768),
    (16, 768, 5, 640, 768),
    (32, 640, 5, 640, 768),
    (32, 640, 5, 640, 896),
    (32, 768, 5, 640, 768),
    (32, 896, 5, 640, 896),
    (3, 13, 1, 1, 128),
    (3, 13, 1, 641, 768),
    (2, 21, 5, 641, 768),
    (2, 13, 16, 1664, 1664),
    (2, 800, 16, 641, 640),
    (1, 7, 9, 1664, 256),
    (4, 37, 3, 1664, 384),
]
# (N, L, C, W, JP, taps) for the card: unaligned C * W with L = 13, one and
# nine channels, W = 1664 (split into channel chunks at 16 channels), and
# enough items that every persistent block walks several, at each rung.
BANDED_CUDA_CASES = [
    (2, 13, 5, 641, 768, 64),
    (3, 24, 1, 300, 256, 32),
    (2, 16, 9, 640, 640, 128),
    (2, 9, 3, 1664, 1664, 32),
    (1, 8, 16, 1664, 384, 64),
    (16, 800, 3, 640, 640, 32),
    (16, 800, 3, 640, 640, 64),
    (16, 800, 3, 640, 640, 128),
]


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('border', [0.0, 0.5])
def test_row_shift_window_slab_bit_exact(seed, border):
    x, starts, ow = _slab_case(seed)
    ref = np.asarray(PK.row_shift_window_slab(
        jnp.asarray(x), jnp.asarray(starts), ow, border_value=border
    ))
    got = K.row_shift_window_slab(
        torch.from_numpy(x), torch.from_numpy(starts), ow, border
    ).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize('kind,c,w,ow', SLAB_CASES)
def test_row_shift_window_slab_cases_bit_exact(kind, c, w, ow):
    x, starts, ow = _slab_kind_case(kind, c, w, ow)
    ref = np.asarray(PK.row_shift_window_slab(
        jnp.asarray(x), jnp.asarray(starts), ow, border_value=255.0
    ))
    got = K.row_shift_window_slab(
        torch.from_numpy(x), torch.from_numpy(starts), ow, 255.0
    ).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize('kind', ['main_path', 'wrap'])
def test_row_shift_window_odd_width_bit_exact(kind):
    x, starts, ow = _slab_kind_case(kind, 1, 637, 509, seed=3)
    x = x[:, :, 0]
    ref = np.asarray(PK.row_shift_window(
        jnp.asarray(x), jnp.asarray(starts), ow, border_value=255.0,
        interpret=True,
    ))
    got = K.row_shift_window(torch.from_numpy(x), torch.from_numpy(starts),
                             ow, 255.0).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('border', [0.0, 255.0])
def test_row_shift_window_bit_exact(seed, border):
    x, starts, ow = _window_case(seed)
    ref = np.asarray(PK.row_shift_window(
        jnp.asarray(x), jnp.asarray(starts), ow, border_value=border,
        interpret=True,
    ))
    got = K.row_shift_window(torch.from_numpy(x), torch.from_numpy(starts),
                             ow, border).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize('seed', [0, 1])
def test_row_shift_bit_exact(seed):
    x, starts, ow = _row_shift_case(seed)
    ref = np.asarray(PK.row_shift_auto(
        jnp.asarray(x), jnp.asarray(starts), ow
    ))
    got = K.row_shift(torch.from_numpy(x), torch.from_numpy(starts),
                      ow).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize('name,m,ow,kind', ROW_SHIFT_CASES)
def test_row_shift_cases_bit_exact(name, m, ow, kind):
    """Inside the contract the plain version equals the Pallas kernel in
    interpret mode; outside it (where the TPU kernel is undefined) it clamps
    each index into the row."""
    x, starts, ow = _row_shift_kind_case(m, ow, kind)
    got = K.row_shift(torch.from_numpy(x), torch.from_numpy(starts),
                      ow).numpy()
    assert np.array_equal(_row_shift_numpy(x, starts, ow), got)
    if kind != 'outside':
        ref = np.asarray(PK.row_shift_auto(
            jnp.asarray(x), jnp.asarray(starts), ow
        ))
        assert np.array_equal(ref, got)


@pytest.mark.parametrize('taps', [32, 64, 128])
def test_banded_line_resample_matches_pallas(taps):
    x, base, pos = _banded_case(taps, taps)
    ref = np.asarray(PK.banded_line_resample(
        jnp.asarray(x), jnp.asarray(base), jnp.asarray(pos), taps,
        border_value=7.0,
    ))
    got = K.banded_line_resample(
        torch.from_numpy(x), torch.from_numpy(base), torch.from_numpy(pos),
        taps, 7.0,
    ).numpy()
    # Two taps against the reference's full tap sum: the zero-weight taps
    # add exact zeros, so only XLA's FMA contraction of the blend differs.
    assert np.abs(ref - got).max() <= 1e-4


@pytest.mark.parametrize('sms', [114, 132])
@pytest.mark.parametrize('n,l,c,w,jp', BANDED_LAUNCH_SHAPES)
def test_banded_launch_covers_every_line_once(n, l, c, w, jp, sms):
    """K3's launch parameters on an H100 PCIe (114 SMs) and SXM (132):
    shared memory within a block's 227 KB, G divides 8, the persistent grid
    within the SMs' residency, and the items cover every (n, line, channel)
    exactly once without an item crossing an 8-line base group."""
    launch = K.banded_launch(n, l, c, w, sms=sms)
    assert launch.smem_bytes <= K.SMEM_PER_BLOCK
    assert launch.smem_bytes >= (K.K3_HEADER_BYTES
                                 + 2 * 4 * launch.stage_floats)
    assert 8 % launch.lines_per_item == 0
    assert launch.stage_floats % 4 == 0
    assert 1 <= launch.blocks_per_sm <= K.K3_BLOCKS_PER_SM
    assert 1 <= launch.grid <= min(launch.items, sms * launch.blocks_per_sm)
    seen = np.zeros((n, l, c), np.int64)
    for item in range(launch.items):
        i, l0, lines, c0, cn = K.banded_item(launch, l, c, item)
        assert lines >= 1 and cn >= 1
        assert lines == 1 or cn == c          # a source range is contiguous
        assert l0 // 8 == (l0 + lines - 1) // 8
        # The staged floats, up to 3 ahead for the 16-byte phase.
        assert lines * cn * w + 3 <= launch.stage_floats
        seen[i, l0:l0 + lines, c0:c0 + cn] += 1
    assert (seen == 1).all()


def test_banded_launch_uses_the_shared_memory_budget():
    """A line that outgrows a stage is split into channel chunks; small
    lines are grouped up to 8 to a stage."""
    wide = K.banded_launch(2, 13, 16, 1664, sms=132)
    assert wide.lines_per_item == 1 and wide.chunks > 1
    assert 4 * wide.chunk * 1664 <= K.K3_STAGE_BYTES
    narrow = K.banded_launch(2, 13, 1, 300, sms=132)
    assert narrow.lines_per_item == 8 and narrow.chunks == 1
    page = K.banded_launch(8, 640, 7, 640, sms=132)
    assert (page.lines_per_item, page.chunks) == (2, 1)
    assert page.grid == 132 * page.blocks_per_sm < page.items


def test_plain_versions_do_not_count_launches():
    K.reset_launch_counts()
    x, starts, ow = _slab_case(0)
    K.row_shift_window_slab(torch.from_numpy(x), torch.from_numpy(starts), ow)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}


@pytest.mark.parametrize('case', ['dtype', 'shape', 'window', 'taps',
                                  'contiguous'])
def test_wrappers_reject_bad_input(case):
    x, starts, ow = _slab_case(0)
    xt, st = torch.from_numpy(x), torch.from_numpy(starts)
    with pytest.raises((TypeError, ValueError)):
        if case == 'dtype':
            K.row_shift_window_slab(xt.double(), st, ow)
        elif case == 'shape':
            K.row_shift_window_slab(xt, st[:, :-1].contiguous(), ow)
        elif case == 'window':
            K.row_shift_window_slab(xt, st, K.WINDOW)
        elif case == 'taps':
            xb, base, pos = _banded_case(0, 32)
            K.banded_line_resample(torch.from_numpy(xb),
                                   torch.from_numpy(base),
                                   torch.from_numpy(pos), 129)
        else:
            K.row_shift_window_slab(xt.transpose(0, 1), st.T, ow)


@pytest.mark.parametrize('dtype', TS.DTYPES, ids=TS.dtype_id)
@pytest.mark.parametrize('channels', TS.CHANNELS)
@pytest.mark.parametrize('kind', TS.QUADRANT_KINDS)
def test_quadrant_slab_plain_equals_the_composed_ops(kind, channels, dtype):
    images, quadrants = TS.slab_case(kind, channels, dtype)
    want = TS.composed_slab(images, quadrants)
    assert torch.equal(K.quadrant_slab(images, quadrants), want)
    if kind == 'zero':
        assert torch.equal(K.quadrant_slab(images), want)


@pytest.mark.parametrize('layout', list(K.LINE_BLEND_LAYOUTS))
@pytest.mark.parametrize('border', [0.0, 255.0])
@pytest.mark.parametrize('channels', TS.CHANNELS)
@pytest.mark.parametrize('route', TS.ROUTES)
def test_line_blend_plain_equals_the_composed_ops(route, channels, border,
                                                  layout):
    window, plan = TS.blend_case(route, channels, border)
    got = K.line_blend(window, plan.i0, plan.frac_j, plan.phi, layout)
    want = TS.composed_blend(window, plan, layout)
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize('border', [0.0, 255.0])
@pytest.mark.parametrize('dtype', TS.DTYPES, ids=TS.dtype_id)
@pytest.mark.parametrize('kind', TS.QUADRANT_KINDS)
def test_affine_warp_equals_the_composed_ops(kind, dtype, border):
    """The whole two-shear warp through the slab and blend against the
    composition it replaced, bit for bit."""
    images, quadrants, plan, statics = TS.affine_case(kind, dtype)
    want = TS.composed_affine_warp(images, quadrants, plan, statics, border)
    got = warp_mxu.apply_affine_warp_quad(images, quadrants, plan, statics,
                                          border_value=border)
    assert got.dtype == dtype and torch.equal(got, want)
    if kind == 'zero':
        assert not quadrants.any()
        assert torch.equal(warp_mxu.apply_affine_warp(
            images, plan, statics, border_value=border), want)


@pytest.mark.parametrize('case', [
    'slab_dtype', 'slab_shape', 'slab_contiguous', 'slab_quadrant_range',
    'slab_quadrant_shape', 'slab_turn_non_square', 'blend_dtype',
    'blend_shape', 'blend_contiguous', 'blend_width', 'blend_layout',
])
def test_two_shear_wrappers_reject_bad_input(case):
    images, quadrants = TS.slab_case('mixed', 5, torch.float32)
    window, plan = TS.blend_case('k1', 5, 0.0)
    args = [window, plan.i0, plan.frac_j, plan.phi]
    with pytest.raises((TypeError, ValueError)):
        if case == 'slab_dtype':
            K.quadrant_slab(images.double(), quadrants)
        elif case == 'slab_shape':
            K.quadrant_slab(images[0], quadrants)
        elif case == 'slab_contiguous':
            K.quadrant_slab(images.transpose(1, 2), quadrants)
        elif case == 'slab_quadrant_range':
            K.quadrant_slab(images, quadrants + 1)
        elif case == 'slab_quadrant_shape':
            K.quadrant_slab(images, quadrants[:-1])
        elif case == 'slab_turn_non_square':
            K.quadrant_slab(images[:, :-1].contiguous(), quadrants)
        elif case == 'blend_dtype':
            K.line_blend(window, plan.i0.long(), *args[2:])
        elif case == 'blend_shape':
            K.line_blend(window, plan.i0, plan.frac_j, plan.phi[:, :-1])
        elif case == 'blend_contiguous':
            K.line_blend(window.transpose(0, 1), *args[1:])
        elif case == 'blend_width':
            K.line_blend(window[..., :2].contiguous(), *args[1:])
        else:
            K.line_blend(*args, layout='nclj')


def test_port_never_imports_jax():
    pattern = re.compile(r'^\s*(import\s+jax\b|from\s+jax\b)', re.MULTILINE)
    sources = sorted(PORT_ROOT.rglob('*.py'))
    assert sources
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    smoke = (PORT_ROOT.parent / 'chip_smoke.py').read_text()
    assert not pattern.search(smoke)
    # The smoke script reaches the shared host layers through the port.
    assert not re.search(r'^\s*(import|from)\s+vkit_tpu\b(?!_torch)', smoke,
                         re.MULTILINE)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    with pytest.raises(RuntimeError):
        convert.resolve_device('cuda')
    from vkit_tpu_torch.mechanism.batched import batched_plan_warp
    from vkit_tpu_torch.host import matrix_plan

    plans = [matrix_plan(np.eye(3), (8, 8), (8, 8))]
    with pytest.raises(RuntimeError):
        batched_plan_warp(plans, np.zeros((1, 8, 8, 3), np.uint8),
                          device='cuda')


def test_cuda_row_shift_window_matches_plain(cuda_device):
    x, starts, ow = _window_case(5)
    xt = torch.from_numpy(x).to(cuda_device)
    st = torch.from_numpy(starts).to(cuda_device)
    before = K.LAUNCHES['row_shift_window']
    got = K.row_shift_window(xt, st, ow, 255.0)
    assert K.LAUNCHES['row_shift_window'] == before + 1
    assert torch.equal(got, K.row_shift_window_plain(xt, st, ow, 255.0))


@pytest.mark.parametrize('kind,c,w,ow', SLAB_CASES)
def test_cuda_row_shift_window_slab_cases(cuda_device, kind, c, w, ow):
    x, starts, ow = _slab_kind_case(kind, c, w, ow, seed=7, b=3, l=50)
    xt = torch.from_numpy(x).to(cuda_device)
    st = torch.from_numpy(starts).to(cuda_device)
    before = K.LAUNCHES['row_shift_window_slab']
    got = K.row_shift_window_slab(xt, st, ow, 255.0)
    assert K.LAUNCHES['row_shift_window_slab'] == before + 1
    assert torch.equal(got, K.row_shift_window_slab_plain(xt, st, ow, 255.0))
    # A source that starts off a 16-byte boundary (a view one float in).
    xo = torch.empty(x.size + 1, dtype=torch.float32, device=cuda_device)
    xo = xo[1:].view(x.shape)
    xo.copy_(xt)
    assert torch.equal(K.row_shift_window_slab(xo, st, ow, 255.0),
                       K.row_shift_window_slab_plain(xt, st, ow, 255.0))
    # K4: the same device code with one channel.
    x1, s1 = xt[:, :, 0].contiguous(), st
    assert torch.equal(K.row_shift_window(x1, s1, ow, 255.0),
                       K.row_shift_window_plain(x1, s1, ow, 255.0))


@pytest.mark.parametrize('name,m,ow,kind', ROW_SHIFT_CASES)
def test_cuda_row_shift_cases(cuda_device, name, m, ow, kind):
    x, starts, ow = _row_shift_kind_case(m, ow, kind, seed=9, b=3, l=131)
    xt = torch.from_numpy(x).to(cuda_device)
    st = torch.from_numpy(starts).to(cuda_device)
    before = K.LAUNCHES['row_shift']
    got = K.row_shift(xt, st, ow)
    assert K.LAUNCHES['row_shift'] == before + 1
    ref = K.row_shift_plain(xt, st, ow)
    assert torch.equal(got, ref)
    # Padded rows that start one float off a 16-byte boundary.
    xo = torch.empty(x.size + 1, dtype=torch.float32, device=cuda_device)
    xo = xo[1:].view(x.shape)
    xo.copy_(xt)
    assert torch.equal(K.row_shift(xo, st, ow), ref)


def test_cuda_kernels_match_plain(cuda_device):
    x, starts, ow = _slab_case(3)
    xt = torch.from_numpy(x).to(cuda_device)
    st = torch.from_numpy(starts).to(cuda_device)
    assert torch.equal(K.row_shift_window_slab(xt, st, ow, 0.5),
                       K.row_shift_window_slab_plain(xt, st, ow, 0.5))
    x, starts, ow = _row_shift_case(3)
    xt = torch.from_numpy(x).to(cuda_device)
    st = torch.from_numpy(starts).to(cuda_device)
    assert torch.equal(K.row_shift(xt, st, ow),
                       K.row_shift_plain(xt, st, ow))
    for taps in (32, 64, 128):
        x, base, pos = (torch.from_numpy(a).to(cuda_device)
                        for a in _banded_case(4, taps))
        got = K.banded_line_resample(x, base, pos, taps, 7.0)
        ref = K.banded_line_resample_plain(x, base, pos, taps, 7.0)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize('n,l,c,w,jp,taps', BANDED_CUDA_CASES)
def test_cuda_banded_line_resample_cases(cuda_device, n, l, c, w, jp, taps):
    """K3 equals the plain version within 1e-3 (bit for bit expected; the
    test prints it, ``pytest -rP`` shows it), also with x and pos one float
    off 16-byte alignment (a ragged head and tail in every item)."""
    arrays = _banded_case(11, taps, n=n, l=l, c=c, w=w, jp=jp)
    x, base, pos = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    ref = K.banded_line_resample_plain(x, base, pos, taps, 255.0)
    x_off = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    x_off.copy_(x)
    pos_off = torch.empty(pos.numel() + 1, device=cuda_device)[1:].view(
        pos.shape)
    pos_off.copy_(pos)
    exact = []
    for xk, pk in ((x, pos), (x_off, pos_off)):
        before = K.LAUNCHES['banded_line_resample']
        got = K.banded_line_resample(xk, base, pk, taps, 255.0)
        torch.cuda.synchronize()
        assert K.LAUNCHES['banded_line_resample'] == before + 1
        assert float((got - ref).abs().max()) <= 1e-3
        exact.append(bool(torch.equal(got, ref)))
    print(f'bit_exact {exact}')
