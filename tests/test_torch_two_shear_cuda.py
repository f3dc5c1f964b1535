"""The two-shear warp's slab and blend kernels (vkit_tpu_torch/ops/kernels.py
``quadrant_slab`` and ``line_blend``, csrc/two_shear.cu) on the card against
their plain PyTorch versions, bit for bit: the CPU tests' cases, both
kernels at the arguments of the rotate cell's warp (32 x 640 x 640 x 5,
rotate plans 73-89 degrees either way) and of a text-region flatten chunk,
and the launches of one ``apply_affine_warp_quad`` call.  Every test needs
an NVIDIA GPU and skips without one.  Imports neither jax nor vkit_tpu:

    python -m pytest tests/test_torch_two_shear_cuda.py
"""
import numpy as np
import pytest
import torch

from vkit_tpu_torch.ops import kernels as K
from vkit_tpu_torch.ops import warp_mxu

from tests import two_shear_cases as TS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def record_two_shear(run):
    """Calls ``run()`` with recorders around the slab and blend wrappers
    that ops/warp_mxu.py calls; returns [(name, args)] in call order, each
    tensor cloned."""
    calls = []
    originals = {name: getattr(warp_mxu, name)
                 for name in ('quadrant_slab', 'line_blend')}

    def recorder(name):
        def record(*args):
            calls.append((name, [a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args]))
            return originals[name](*args)
        return record

    for name in originals:
        setattr(warp_mxu, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(warp_mxu, name, fn)
    torch.cuda.synchronize()
    return calls


def assert_kernels_equal_plain(calls):
    plain = {'quadrant_slab': K.quadrant_slab_plain,
             'line_blend': K.line_blend_plain}
    for name, args in calls:
        got = getattr(K, name)(*args)
        want = plain[name](*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), name


@pytest.mark.parametrize('dtype', TS.DTYPES, ids=TS.dtype_id)
@pytest.mark.parametrize('channels', TS.CHANNELS)
@pytest.mark.parametrize('kind', TS.QUADRANT_KINDS)
def test_cuda_quadrant_slab_cases(cuda_device, kind, channels, dtype):
    images, quadrants = TS.slab_case(kind, channels, dtype)
    images = images.to(cuda_device)
    got = K.quadrant_slab(images, quadrants)
    torch.cuda.synchronize()
    assert torch.equal(got, K.quadrant_slab_plain(images, quadrants))


@pytest.mark.parametrize('layout', list(K.LINE_BLEND_LAYOUTS))
@pytest.mark.parametrize('border', [0.0, 255.0])
@pytest.mark.parametrize('channels', TS.CHANNELS + (9,))
@pytest.mark.parametrize('route', TS.ROUTES)
def test_cuda_line_blend_cases(cuda_device, route, channels, border, layout):
    window, plan = TS.blend_case(route, channels, border, device=cuda_device)
    args = (window, plan.i0, plan.frac_j, plan.phi, layout)
    got = K.line_blend(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, K.line_blend_plain(*args))


@pytest.mark.parametrize('path', ['rotate', 'flatten'])
def test_cuda_two_shear_kernels_at_path_shapes(cuda_device, path):
    run = (TS.rotate_call if path == 'rotate' else TS.flatten_call)(
        cuda_device)
    calls = record_two_shear(run)
    assert [name for name, _ in calls] == [
        'quadrant_slab', 'line_blend', 'line_blend']
    quadrants = calls[0][1][1]
    if path == 'rotate':
        assert calls[0][1][0].shape == (32, 640, 640, 5)
        assert set(np.asarray(quadrants).tolist()) == {1, 3}
    assert_kernels_equal_plain(calls)


def test_cuda_affine_warp_quad_launch_counts(cuda_device):
    images, quadrants, plan, statics = TS.affine_case(
        'mixed', torch.float32, device=cuda_device)
    K.reset_launch_counts()
    got = warp_mxu.apply_affine_warp_quad(images, quadrants, plan, statics)
    torch.cuda.synchronize()
    assert {name: n for name, n in K.LAUNCHES.items() if n} == {
        'quadrant_slab': 1, 'row_shift_window_slab': 2, 'line_blend': 2}
    want = TS.composed_affine_warp(images, quadrants, plan, statics, 0.0)
    assert torch.equal(got, want)
