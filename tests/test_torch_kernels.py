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


def _banded_case(seed, taps, n=2, l=12, c=3, w=300, jp=256):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, l, c, w), dtype=np.float32) * 255).astype(np.float32)
    base = rng.integers(-520, 1300, (n, -(-l // 8), jp // 128))
    full = np.repeat(np.repeat(base, 8, 1)[:, :l], 128, 2)
    # Positions inside and a little outside the band [0, taps - 2].
    pos = full + np.arange(jp) % 128 + rng.uniform(-2, taps + 2, (n, l, jp))
    return x, base.astype(np.int32), pos.astype(np.float32)


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
