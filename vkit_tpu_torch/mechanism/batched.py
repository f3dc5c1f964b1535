"""Batched distortions on the device: the photometric catalog and the
geometric warp of every sample by its own WarpPlan.

Port of vkit_tpu/mechanism/batched.py.

The photometric catalog (``batched_mean_shift`` ... ``batched_ellipse_streak``,
``_finish``) and its per-name dispatch (``batch_distort_images``,
``batch_distort_members``, ``batch_distort_grouped``): the host preps that
turn configs into parameter arrays (``_PREPS``) are the reference's own
code, so both packages derive the same parameters from the same configs.
The rng-consuming ops (the four noises, ``channel_permutation``, ``fog`` and
the rolls branch of ``glass_blur``) draw from a ``torch.Generator`` on the
images' device and match the reference in distribution only.

The geometric half: the device helpers ``_coarse_gather_remap``,
``_coarse_gather_warp``, ``_upsample_node_maps``, ``_scatter_samples``,
``_banded_group_scatter``, ``_merge_subbatches``, ``_affine_sub_warp``
and ``_coarse_mxu_warp``, ``batched_plan_warp`` in modes
``auto``, ``gather`` and ``dense``, and ``batched_grid_warp``, which plans
one geometric distortion per sample on the host and warps through it.
The host side (``plan_backward_maps``,
``_build_coarse_nodes``, ``_bucket_pad``, ``LazyCoverages``, the affine /
banded / gather routing, the plans) is the reference's own code, so both
packages send every sample down the same route, but for one repair: a
sample the banded plan rejects always takes the gather route, which is the
exact bilinear remap (the reference sends some rejects through a 2x
mean-pooled copy and a re-plan at half size); the lattice node maps come
from one native pass a batch (``_lattice_node_pass``) that gives the
reference's node maps bit for bit.  Scatters write in place
into the output batch where the reference donated its buffer.
"""
import logging
from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..ops import blur as blur_ops
from ..ops import color as color_ops
from ..ops import noise as noise_ops
from ..ops.blend import blend
from ..ops.common import scalar
from ..ops.effect import (
    _CHROMA_QTABLE,
    _LUMA_QTABLE,
    _quality_scaled_table,
    diamond_square_mask,
)
from ..ops.jpeg_exact import jpeg_roundtrip_exact_torch
from ..ops.warp import remap_f32, to_image_dtype
from ..ops.warp_banded import (
    _quantize_taps,
    apply_banded_warp,
    banded_warp_body,
    interp_node_weights,
    plan_banded_warp,
    slice_banded_plan,
)
from ..ops.warp_mxu import (
    apply_affine_warp,
    apply_affine_warp_quad,
    apply_dense_warp,
    dense_warp_positions,
    line_tap_needs,
    line_window_needs,
    plan_affine_warp,
    plan_dense_warp_from_positions,
    quadrant_reduce_mats,
)
from ..utility import profiling
from .distortion.photometric.base import OutOfBoundBehavior
from .distortion.photometric.blur import (
    build_glass_blur_permutation,
    estimate_gaussian_kernel_size,
)
from .distortion.warp_plan import plan_content_box

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Host side of the geometric warp (numpy / C++): backward maps, coarse
# nodes, coverages and bucket padding, the reference's own code.
# ---------------------------------------------------------------------------


def _native_repair(map_y, map_x, cov) -> bool:
    """In-place C++ repair of uncovered backward-map pixels; False if the
    native library is unavailable (callers run the numpy loop instead)."""
    try:
        from ..native import load_library
        lib = load_library()
    except Exception:  # noqa: BLE001
        return False
    if lib is None or not hasattr(lib, 'vg_repair_backward_maps'):
        return False
    import ctypes
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cov_u8 = np.ascontiguousarray(cov, dtype=np.uint8)
    assert map_y.flags.c_contiguous and map_x.flags.c_contiguous
    lib.vg_repair_backward_maps(
        map_y.ctypes.data_as(f64p), map_x.ctypes.data_as(f64p),
        cov_u8.ctypes.data_as(u8p), map_y.shape[0], map_y.shape[1],
    )
    return True


def plan_backward_maps(plan, src_shape):
    """(map_y, map_x, coverage) for ANY WarpPlan on its dst canvas.

    Lattice plans repair uncovered dst pixels by row interpolation /
    extension so the shared-slope tap scheme stays monotonic (the active
    mask excludes them anyway); matrix and nop plans cover fully.
    """
    h_in, w_in = src_shape
    from ..ops.warp import affine_maps_np

    if plan.nop:
        ys, xs = np.meshgrid(
            np.arange(h_in, dtype=np.float64),
            np.arange(w_in, dtype=np.float64),
            indexing='ij',
        )
        return ys, xs, np.ones((h_in, w_in), dtype=bool)

    if plan.matrix is not None:
        map_y, map_x = affine_maps_np(plan.matrix, plan.dst_shape)
        return map_y, map_x, np.ones(plan.dst_shape, dtype=bool)

    map_y, map_x, cov = plan.backward_maps()
    map_y = np.asarray(map_y, dtype=np.float64).copy()
    map_x = np.asarray(map_x, dtype=np.float64).copy()
    rows, cols_n = map_x.shape

    native = _native_repair(map_y, map_x, cov)
    if native:
        return map_y, map_x, cov

    cols = np.arange(cols_n, dtype=np.float64)

    # Repair uncovered dst pixels by LINEAR EXTENSION of the covered data.
    # Anything discontinuous here (sentinels, clamps) wrecks the shared-
    # slope two-pass decomposition: tap needs explode and the whole batch
    # falls off the device path.  Extended pixels read outside the source
    # (border value) or bleed a few source pixels; the active mask gates
    # them out downstream either way.
    row_any = cov.any(axis=1)
    covered_rows = np.flatnonzero(row_any)
    row_full = cov.all(axis=1)
    for y in covered_rows:
        if row_full[y]:
            continue  # fully covered row: nothing to repair (common case)
        row_cov = cov[y]
        idx = np.flatnonzero(row_cov)
        first, last = idx[0], idx[-1]
        contiguous = (last - first + 1) == len(idx)
        if not contiguous:
            # Interior holes (rare): interpolate across them.
            fidx = idx.astype(np.float64)
            map_x[y] = np.interp(cols, fidx, map_x[y, idx])
            map_y[y] = np.interp(cols, fidx, map_y[y, idx])
        # Extend with the LOCAL slope at each edge (an 8-px window), not
        # the full-row average: a curved row extended at its tangent stays
        # shape-consistent with its neighbours, keeping the two-pass tap
        # budget small near canvas borders.
        dl = min(last - first, 8)
        if dl > 0:
            sxl = (map_x[y, first + dl] - map_x[y, first]) / dl
            syl = (map_y[y, first + dl] - map_y[y, first]) / dl
            sxr = (map_x[y, last] - map_x[y, last - dl]) / dl
            syr = (map_y[y, last] - map_y[y, last - dl]) / dl
        else:
            sxl = sxr = 1.0
            syl = syr = 0.0
        if first > 0:
            d = cols[:first] - first
            map_x[y, :first] = map_x[y, first] + d * sxl
            map_y[y, :first] = map_y[y, first] + d * syl
        if last < cols_n - 1:
            d = cols[last + 1:] - last
            map_x[y, last + 1:] = map_x[y, last] + d * sxr
            map_y[y, last + 1:] = map_y[y, last] + d * syr
    if len(covered_rows) and len(covered_rows) < rows:
        top, bottom = covered_rows[0], covered_rows[-1]
        dv = min(bottom - top, 8)
        if dv > 0:
            step_y_t = (map_y[top + dv] - map_y[top]) / dv
            step_x_t = (map_x[top + dv] - map_x[top]) / dv
            step_y_b = (map_y[bottom] - map_y[bottom - dv]) / dv
            step_x_b = (map_x[bottom] - map_x[bottom - dv]) / dv
        else:
            step_y_t = step_y_b = np.ones(cols_n)
            step_x_t = step_x_b = np.zeros(cols_n)
        for y in range(0, top):
            map_y[y] = map_y[top] + (y - top) * step_y_t
            map_x[y] = map_x[top] + (y - top) * step_x_t
        for y in range(bottom + 1, rows):
            map_y[y] = map_y[bottom] + (y - bottom) * step_y_b
            map_x[y] = map_x[bottom] + (y - bottom) * step_x_b
        # Interior rows with no coverage (rare): nearest covered row.
        interior = np.flatnonzero(~row_any)
        interior = interior[(interior > top) & (interior < bottom)]
        for y in interior:
            y0 = covered_rows[np.argmin(np.abs(covered_rows - y))]
            near_top = (y0 - top) <= (bottom - y0)
            map_y[y] = map_y[y0] + (y - y0) * (
                step_y_t if near_top else step_y_b
            )
            map_x[y] = map_x[y0] + (y - y0) * (
                step_x_t if near_top else step_x_b
            )
    return map_y, map_x, cov


def _matrix_nodes(plan, ys, xs):
    """Evaluate a matrix/nop plan's backward map at node coordinates."""
    if plan.nop or plan.matrix is None:
        gy, gx = np.meshgrid(ys.astype(np.float64),
                             xs.astype(np.float64), indexing='ij')
        return gy, gx
    mat3 = np.eye(3, dtype=np.float64)
    m = np.asarray(plan.matrix, dtype=np.float64)
    mat3[:m.shape[0]] = m
    inv = np.linalg.inv(mat3)
    gx = xs.astype(np.float64)[None, :]
    gy = ys.astype(np.float64)[:, None]
    sx = inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]
    sy = inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]
    if np.abs(inv[2, :2]).max() > 1e-12:
        w = inv[2, 0] * gx + inv[2, 1] * gy + inv[2, 2]
        w = np.where(np.abs(w) < 1e-12, 1.0, w)
        sx = sx / w
        sy = sy / w
    return sy, sx


def _lattice_node_pass(plans, rows, ys, xs, coarse_y, coarse_x,
                       repair=True, covered=None) -> bool:
    """Node maps of lattice ``plans`` into rows ``rows`` of the float32
    (n, len(ys), len(xs)) arrays ``coarse_y`` / ``coarse_x``, in one native
    call (``vg_lattice_node_maps_batch``, native/node_maps.cpp).

    A node takes the inverse homography of the last cell whose quad
    covers its pixel by vg_fill_poly's rule (scanline spans and outline),
    decided at the node alone; with ``repair`` the uncovered nodes are
    then filled as vkit_tpu's ``_repair_node_maps`` fills them, in float64
    on the float32-rounded values.  ``covered`` (uint8, (len(plans), len(ys),
    len(xs))) receives the coverage.  False, writing nothing, when the
    native library is unavailable."""
    try:
        from ..native import load_library
        lib = load_library()
    except Exception:  # noqa: BLE001
        return False
    if lib is None or not hasattr(lib, 'vg_lattice_node_maps_batch'):
        return False
    import ctypes
    lattices = [np.ascontiguousarray(p._int_lattice('dst'), dtype=np.int64)
                for p in plans]
    mats = [np.ascontiguousarray(p._cell_mats(inverse=True), dtype=np.float64)
            for p in plans]
    for lat, mat in zip(lattices, mats):
        assert len(mat) == (lat.shape[0] - 1) * (lat.shape[1] - 1)
    n = len(plans)
    lat_shapes = np.asarray([lat.shape[:2] for lat in lattices], np.int32)
    dst_shapes = np.asarray([p.dst_shape for p in plans], np.int32)
    ys32 = np.ascontiguousarray(ys, dtype=np.int32)
    xs32 = np.ascontiguousarray(xs, dtype=np.int32)
    out_rows = np.ascontiguousarray(rows, dtype=np.int64)
    assert coarse_y.flags.c_contiguous and coarse_x.flags.c_contiguous
    assert coarse_y.dtype == coarse_x.dtype == np.float32
    assert coarse_y.shape == coarse_x.shape
    assert coarse_y.shape[1:] == (len(ys), len(xs))
    assert len(out_rows) == n and (out_rows < len(coarse_y)).all()
    if covered is not None:
        assert covered.dtype == np.uint8 and covered.flags.c_contiguous
        assert covered.shape == (n, len(ys), len(xs))
    ptrs = ctypes.c_void_p * n
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.vg_lattice_node_maps_batch(
        n, ptrs(*[a.ctypes.data for a in lattices]),
        lat_shapes.ctypes.data_as(i32p),
        ptrs(*[m.ctypes.data for m in mats]),
        dst_shapes.ctypes.data_as(i32p),
        ys32.ctypes.data_as(i32p), len(ys32),
        xs32.ctypes.data_as(i32p), len(xs32),
        out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), int(repair),
        coarse_y.ctypes.data_as(f32p), coarse_x.ctypes.data_as(f32p),
        None if covered is None
        else covered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return True


def lattice_node_maps(plan, ys, xs):
    """(cy, cx) float32 node maps of a lattice plan, repaired at node
    level: each node evaluated alone by the cells' fill rule, as
    ``_lattice_node_pass`` does for a batch; None when the native kernel
    is unavailable (callers fall back to full-resolution maps +
    subsampling)."""
    cy = np.empty((1, len(ys), len(xs)), dtype=np.float32)
    cx = np.empty_like(cy)
    if not _lattice_node_pass([plan], [0], ys, xs, cy, cx):
        return None
    return cy[0], cx[0]


# Coarse-node spacing of the banded/gather warp paths.  The node arrays
# are per-draw jit ARGUMENTS, so on a slow host<->device link their
# transfer dominates the randomized warp step (~2 MB/step at 8 px on a
# 704^2 canvas).  16 px keeps the documented fidelity bars on
# production-size canvases (max <= 24 LSB at isolated high-gradient
# pixels, mean <= 1 LSB — the catalog's fields are piecewise-projective
# per lattice cell with grid_size >= 16, re-verified by
# tests/ops/test_dense_warp at this spacing) at a 4x transfer/planning
# cut.  Small canvases keep the 8-px grid: their fields bend faster
# relative to the node spacing (same lattice curvature over far fewer
# nodes), and their node arrays are tiny anyway.
COARSE_NODE_STEP = 16
_FINE_NODE_CANVAS = 320      # min(canvas) below this -> 8-px nodes


def _build_coarse_nodes(map_list, shapes, canvas, node_step: Optional[int] = None):
    """Sample every sample's backward field at shared coarse nodes.

    ``map_list`` entries are either (map_y, map_x) full-res arrays or
    WarpPlan objects.  Lattice plans are evaluated at the node pixels
    alone, all of them in one native pass (``_lattice_node_pass``: the
    cells' fill rule tested at each node, then the node repair); without
    the native library each takes its full-resolution maps.  Matrix/nop
    plans are evaluated analytically at the nodes, valid beyond the dst
    canvas too.  Counts the lattice samples each way
    (``plan_warp.nodes.native``, ``plan_warp.nodes.fullres``).  Returns
    (coarse_y, coarse_x, ys, xs) with linear extension beyond each
    sample's own canvas."""
    if node_step is None:
        node_step = (
            8 if min(canvas) < _FINE_NODE_CANVAS else COARSE_NODE_STEP
        )
    h_max, w_max = canvas
    n = len(map_list)
    ys = np.round(
        np.linspace(0, h_max - 1, max(2, (h_max - 1) // node_step + 1))
    ).astype(np.int64)
    xs = np.round(
        np.linspace(0, w_max - 1, max(2, (w_max - 1) // node_step + 1))
    ).astype(np.int64)
    # Symmetric grids let per-sample axis flips reuse reversed node values
    # (ops/warp_banded.py).
    ys = np.unique(np.concatenate([ys, h_max - 1 - ys]))
    xs = np.unique(np.concatenate([xs, w_max - 1 - xs]))

    coarse_y = np.empty((n, len(ys), len(xs)), dtype=np.float32)
    coarse_x = np.empty((n, len(ys), len(xs)), dtype=np.float32)
    lattice = [idx for idx, entry in enumerate(map_list)
               if not isinstance(entry, tuple)
               and getattr(entry, 'is_lattice', False)]
    native = bool(lattice) and _lattice_node_pass(
        [map_list[idx] for idx in lattice], lattice, ys, xs,
        coarse_y, coarse_x,
    )
    if lattice:
        profiling.count('plan_warp.nodes.native' if native
                        else 'plan_warp.nodes.fullres', len(lattice))
    for idx, entry in enumerate(map_list):
        if not isinstance(entry, tuple):
            if getattr(entry, 'is_lattice', False):
                if native:
                    continue
                entry = plan_backward_maps(entry, entry.src_shape)[:2]
            else:
                cy, cx = _matrix_nodes(entry, ys, xs)
                coarse_y[idx] = cy
                coarse_x[idx] = cx
                continue
        my, mx = entry
        h, w = shapes[idx]
        if h == h_max and w == w_max:
            coarse_y[idx] = my[np.ix_(ys, xs)]
            coarse_x[idx] = mx[np.ix_(ys, xs)]
            continue
        # Linear extension beyond this sample's dst canvas (same rule as
        # the dense padding path): extend columns then rows.
        ys_in = np.minimum(ys, h - 1)
        xs_in = np.minimum(xs, w - 1)
        cy = my[np.ix_(ys_in, xs_in)].astype(np.float64)
        cx = mx[np.ix_(ys_in, xs_in)].astype(np.float64)
        over_x = xs > w - 1
        if over_x.any() and w > 1:
            # Local edge slope (8-px window) — see plan_backward_maps.
            dl = min(w - 1, 8)
            step_x = (mx[ys_in, w - 1] - mx[ys_in, w - 1 - dl]) / dl
            step_y = (my[ys_in, w - 1] - my[ys_in, w - 1 - dl]) / dl
            d = (xs[over_x] - (w - 1)).astype(np.float64)
            cx[:, over_x] = mx[ys_in, w - 1][:, None] + d[None, :] * step_x[:, None]
            cy[:, over_x] = my[ys_in, w - 1][:, None] + d[None, :] * step_y[:, None]
        over_y = ys > h - 1
        if over_y.any() and h > 1:
            inside = np.flatnonzero(~over_y)
            last = inside[-1]
            prev = inside[-2] if len(inside) > 1 else inside[-1]
            gap = max(int(ys[last] - ys[prev]), 1)
            step_cy = (cy[last] - cy[prev]) / gap
            step_cx = (cx[last] - cx[prev]) / gap
            d = (ys[over_y] - ys[last]).astype(np.float64)
            cy[over_y] = cy[last][None, :] + d[:, None] * step_cy[None, :]
            cx[over_y] = cx[last][None, :] + d[:, None] * step_cx[None, :]
        coarse_y[idx] = cy
        coarse_x[idx] = cx

    return coarse_y, coarse_x, ys, xs


class LazyCoverages:
    """Per-sample coverage planes, materialized on ACCESS: the lattice
    coverage is a host polygon rasterization per plan per batch, and no
    hot caller consumes it (bench/synth gate by their own active masks).
    Matrix/nop coverage is a zero-copy broadcast view."""

    def __init__(self, plans):
        self._plans = list(plans)
        self._cache = {}

    def __len__(self):
        return len(self._plans)

    def __getitem__(self, i):
        if i not in self._cache:
            plan = self._plans[i]
            if getattr(plan, 'is_lattice', False):
                from .distortion.warp_plan import warp_active_mask
                self._cache[i] = warp_active_mask(plan).mat.astype(bool)
            else:
                self._cache[i] = np.broadcast_to(True, plan.dst_shape)
        return self._cache[i]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _bucket_pad(idx: np.ndarray, n: int,
                ladder=(8, 16, 32, 64)) -> np.ndarray:
    """Pad an index subset to a fixed bucket-size ladder (each sub-batch
    size is a distinct compiled program; padding repeats the first index,
    whose duplicate scatter writes are identical values)."""
    for b in ladder:
        if len(idx) <= b <= n:
            return np.concatenate([
                idx, np.full(b - len(idx), idx[0], dtype=idx.dtype)
            ])
    return idx


# ---------------------------------------------------------------------------
# Device side of the geometric warp.
# ---------------------------------------------------------------------------


_INTERP_W_CACHE: Dict[Tuple[int, bytes], np.ndarray] = {}


def _interp_weights(length: int, nodes: np.ndarray, device) -> torch.Tensor:
    """(length, len(nodes)) float32 bilinear weights through node rows
    (the numbers of the reference's ``_interp_weights``, built by its
    numpy twin ``interp_node_weights``), cached by (length, node grid) as
    host numpy where the reference caches a device array."""
    key = (length, np.asarray(nodes).tobytes())
    weights = _INTERP_W_CACHE.get(key)
    if weights is None:
        weights = interp_node_weights(length, np.asarray(nodes))
        if len(_INTERP_W_CACHE) > 64:
            _INTERP_W_CACHE.clear()
        _INTERP_W_CACHE[key] = weights
    return convert.to_tensor(weights, device, torch.float32)


def _upsample(w_y, coarse, w_x):
    # m[n, h, w] = sum_{r, c} w_y[h, r] coarse[n, r, c] w_x[w, c].
    return torch.matmul(torch.matmul(w_y, coarse), w_x.T)


def _upsample_node_maps(coarse_y, coarse_x, w_y, w_x):
    """Full-res (map_ys, map_xs) from node maps."""
    return _upsample(w_y, coarse_y, w_x), _upsample(w_y, coarse_x, w_x)


def _coarse_gather_remap(stack_f32, coarse_y, coarse_x, w_y, w_x, border):
    """Upsample the coarse backward maps + bilinear gather.  Returns
    (warped, map_y_full, map_x_full)."""
    my, mx = _upsample_node_maps(coarse_y, coarse_x, w_y, w_x)
    return remap_f32(stack_f32, my, mx, border), my, mx


def _coarse_gather_warp(images, map_list, shapes, canvas, border_value,
                        node_step: Optional[int] = None, nodes=None):
    """Gather-warp a batch from node-sampled backward maps (the fallback
    when the banded two-pass rejects the field)."""
    h_max, w_max = canvas
    if nodes is None:
        nodes = _build_coarse_nodes(map_list, shapes, canvas, node_step)
    coarse_y, coarse_x, ys, xs = nodes
    device = images.device
    warped, my_full, mx_full = _coarse_gather_remap(
        images.to(torch.float32),
        convert.to_tensor(coarse_y, device, torch.float32),
        convert.to_tensor(coarse_x, device, torch.float32),
        _interp_weights(h_max, ys, device),
        _interp_weights(w_max, xs, device),
        float(border_value),
    )
    return to_image_dtype(warped, images.dtype), (my_full, mx_full)


def _scatter_samples(out, idx, values):
    """``out[idx] = values`` in place (duplicate bucket-padding indices
    write identical values)."""
    out[torch.as_tensor(idx, device=out.device)] = values.to(out.dtype)
    return out


def _banded_group_scatter(out, x, idx, plan, flip_v, flip_h, canvas, taps,
                          border_value, init):
    """Gather a tap-homogeneous sub-batch, run both banded passes + unflip,
    scatter into the batch canvas (``init`` allocates it)."""
    device = x.device
    sub = x[torch.as_tensor(idx, device=device)]
    res = banded_warp_body(sub, plan, canvas, taps, flips=(flip_v, flip_h),
                           border_value=border_value)
    if init:
        h, w = canvas
        out = torch.zeros((x.shape[0], h, w) + tuple(x.shape[3:]),
                          dtype=res.dtype, device=device)
    return _scatter_samples(out, idx, res)


def _merge_subbatches(idx_a, wa, idx_b, wb, n):
    """Scatter two warped sub-batches onto one zeroed batch canvas."""
    out = torch.zeros((n,) + tuple(wa.shape[1:]), dtype=wa.dtype,
                      device=wa.device)
    _scatter_samples(out, idx_a, wa)
    return _scatter_samples(out, idx_b, wb)


def _affine_sub_warp(x, idx, quads, aplan, statics, border_value,
                     gather, use_quads):
    """The affine sub-batch: optional gather + the two-shear warp (with
    per-sample rot90 conditioning when any quadrant reduction fired)."""
    sub = x[torch.as_tensor(idx, device=x.device)] if gather else x
    if use_quads:
        return apply_affine_warp_quad(sub, quads, aplan, statics,
                                      border_value=border_value)
    return apply_affine_warp(sub, aplan, statics, border_value=border_value)


def _coarse_mxu_warp(images, nodes, src_shape, canvas, border_value,
                     return_maps: bool, content_boxes=None,
                     samples: Optional[int] = None):
    """Banded two-pass warp from node maps; samples the decomposition
    rejects run the gather program as a sub-batch and overwrite their
    rows.  Returns None only when every sample rejects.  ``samples``: how
    many leading rows are samples of the caller's batch (the rest pad a
    bucket); only those count on the route counters (all rows by
    default)."""
    span, count = profiling.span, profiling.count
    coarse_y, coarse_x, ys, xs = nodes
    n = len(coarse_y)
    counted = n if samples is None else samples
    device = images.device
    with span('plan_warp.band_plan'):
        planned = plan_banded_warp(
            coarse_y, coarse_x, ys, xs, src_shape, canvas,
            content_boxes=content_boxes,
        )
    if planned is None:
        return None
    plan, taps, rejects, flips, needs = planned

    orig_dtype = images.dtype
    reject_set = set(int(r) for r in rejects)
    acc = np.asarray(
        [i for i in range(n) if i not in reject_set], dtype=np.int64
    )
    groups = [(acc, _quantize_taps(int(needs[acc].max())))] \
        if len(acc) else []
    count('plan_warp.samples.banded', int(np.count_nonzero(acc < counted)))

    with span('plan_warp.enqueue'):
        x = images.to(torch.float32)
        if len(groups) == 1 and len(groups[0][0]) == n:
            warped = apply_banded_warp(
                x, convert.banded_warp_plan(plan, device), canvas,
                groups[0][1], flips=flips, border_value=border_value,
            )
        else:
            warped = None
            for pos, (gidx, gtaps) in enumerate(groups):
                gpad = _bucket_pad(gidx, n)
                warped = _banded_group_scatter(
                    warped, x, gpad,
                    convert.banded_warp_plan(slice_banded_plan(plan, gpad),
                                             device),
                    flips[0][gpad], flips[1][gpad],
                    tuple(canvas), gtaps, border_value, pos == 0,
                )
    if len(rejects):
        # Gather route for every reject: fold-overs, tap needs past the
        # ladder, extreme zooms.
        ridx = _bucket_pad(rejects, n, ladder=(8, 16))
        with span('plan_warp.enqueue'):
            sub = x[torch.as_tensor(ridx, device=device)]
            sub_nodes = (coarse_y[ridx], coarse_x[ridx], ys, xs)
            res, _ = _coarse_gather_warp(
                sub, [None] * len(ridx), None, canvas, border_value,
                nodes=sub_nodes,
            )
            warped = _scatter_samples(warped, ridx, res)
        count('plan_warp.samples.gather',
              int(np.count_nonzero(np.asarray(rejects) < counted)))

    with span('plan_warp.enqueue'):
        warped = to_image_dtype(warped, orig_dtype)
        dev_maps = None
        if return_maps:
            h_max, w_max = canvas
            dev_maps = _upsample_node_maps(
                convert.to_tensor(coarse_y, device, torch.float32),
                convert.to_tensor(coarse_x, device, torch.float32),
                _interp_weights(h_max, ys, device),
                _interp_weights(w_max, xs, device),
            )
    return warped, dev_maps


def _dense_plan_warp(plans, images, shapes, canvas, border_value, taps_max,
                     return_maps):
    """``batched_plan_warp(mode='dense')``: every sample's full-resolution
    backward maps, padded to the batch canvas by linear extension."""
    n, h_in, w_in = images.shape[:3]
    h_max, w_max = canvas
    map_list = []
    coverages = []
    for plan in plans:
        map_y, map_x, cov = plan_backward_maps(plan, (h_in, w_in))
        map_list.append((map_y, map_x))
        coverages.append(cov)

    map_ys = np.zeros((n, h_max, w_max), dtype=np.float32)
    map_xs = np.zeros((n, h_max, w_max), dtype=np.float32)
    for idx, (my, mx) in enumerate(map_list):
        h, w = my.shape
        map_ys[idx, :h, :w] = my
        map_xs[idx, :h, :w] = mx
        # Pad beyond each sample's canvas by linear extension (smooth maps
        # keep the two-pass tap budget small; extended pixels resolve to
        # the border or are gated by the active mask downstream).
        if w < w_max:
            pad = np.arange(1, w_max - w + 1, dtype=np.float64)
            step_x = (mx[:, -1:] - mx[:, :1]) / max(w - 1, 1)
            step_y = (my[:, -1:] - my[:, :1]) / max(w - 1, 1)
            map_xs[idx, :h, w:] = mx[:, -1:] + pad[None, :] * step_x
            map_ys[idx, :h, w:] = my[:, -1:] + pad[None, :] * step_y
        if h < h_max:
            pad = np.arange(1, h_max - h + 1, dtype=np.float64)
            step_x = (map_xs[idx, h - 1] - map_xs[idx, 0]) / max(h - 1, 1)
            step_y = (map_ys[idx, h - 1] - map_ys[idx, 0]) / max(h - 1, 1)
            map_xs[idx, h:] = map_xs[idx, h - 1][None] \
                + pad[:, None] * step_x[None]
            map_ys[idx, h:] = map_ys[idx, h - 1][None] \
                + pad[:, None] * step_y[None]

    # Routing, as the reference's: the two-pass covers fields whose
    # non-separable residual fits the tap budget (affine chains, mild grid
    # warps); a batch that holds a stronger draw runs as one
    # bilinear-gather program instead.
    pos_v, map_xs_fixed, row_monotone = dense_warp_positions(
        map_ys, map_xs, (h_in, w_in)
    )
    needs = np.maximum(
        line_tap_needs(pos_v), line_tap_needs(map_xs_fixed)
    )

    def window_fits(spans, in_len):
        slab = in_len + spans + taps_max <= 1792
        return (spans + taps_max <= 832) | slab

    windows_ok = (
        window_fits(line_window_needs(pos_v), h_in)
        & window_fits(line_window_needs(map_xs_fixed), w_in)
    )
    two_pass = bool(
        (row_monotone & (needs <= taps_max) & windows_ok).all()
    )

    if two_pass:
        # A planner assert here is the reference's own routing (its window
        # estimate undershot, rare): the batch takes the gather route, as
        # there.  It hides no failure of a kernel or of the device.
        try:
            plan_, statics = plan_dense_warp_from_positions(
                pos_v, map_xs_fixed, (h_in, w_in), taps_max=taps_max
            )
        except AssertionError:
            plan_ = None
        if plan_ is not None:
            warped = apply_dense_warp(
                images, convert.dense_warp_plan(plan_, images.device),
                statics, border_value=border_value,
            )
            if return_maps:
                return warped, shapes, coverages, (map_ys, map_xs)
            return warped, shapes, coverages

    warped, dev_maps = _coarse_gather_warp(
        images, map_list, shapes, (h_max, w_max), border_value
    )
    if return_maps:
        return warped, shapes, coverages, dev_maps
    return warped, shapes, coverages


def _content_boxes(plans, idx):
    return np.asarray([
        (b.up, b.down, b.left, b.right)
        for b in (plan_content_box(plans[i]) for i in idx)
    ], dtype=np.int64)


def batched_plan_warp(
    plans: Sequence,
    images,
    border_value: float = 0.0,
    taps_max: int = 24,
    return_maps: bool = False,
    canvas_shape: Optional[Tuple[int, int]] = None,
    mode: str = 'auto',
    device=None,
):
    """Warp each batch sample by its own WarpPlan.

    ``images``: (N, H, W, C) tensor (or array, moved to ``device``;
    ``device`` defaults to the tensor's own).  Routing under ``mode='auto'``:
      1. affine samples (nop included) -> the two-shear warp (3 taps,
         per-sample rot90 quadrant reduction);
      2. everything else -> the coarse-node banded two-pass;
      3. fields the banded plan rejects -> the bilinear-gather program.
    ``mode='gather'`` forces 3 for every sample.  ``mode='dense'`` is the
    reference's legacy route: full-resolution backward maps planned into
    the dense two-pass (ops/warp_mxu.py) when every sample's field is
    row-monotone and fits ``taps_max`` taps and a shift window, else the
    bilinear-gather program for the whole batch.

    Returns (warped (N, Hmax, Wmax, C) with the input dtype, result_shapes,
    coverages); with ``return_maps`` also the device (map_ys, map_xs), or
    None when every sample ran the affine route.  Pixels outside a sample's
    coverage are undefined, as in the reference: gate by the active mask.
    ``taps_max`` only applies to the dense mode.

    Modes ``auto`` and ``gather`` record program spans
    (``utility/profiling.py``): ``plan_warp`` around the call and in it
    ``plan_warp.route`` (partition, quadrant reduction, bucket pads,
    content boxes, affine planning), ``plan_warp.nodes`` (each coarse-node
    build), ``plan_warp.band_plan`` (each banded plan, the tail's re-plan
    included) and ``plan_warp.enqueue`` (each stretch that enqueues device
    work); and the counters ``plan_warp.samples.affine``, ``.banded``,
    ``.half`` and ``.gather``, the samples each route served (they sum to
    N).  Mode ``dense`` records none.
    """
    if mode not in ('auto', 'gather', 'dense'):
        raise ValueError(f'unknown mode {mode!r}')
    if device is None and isinstance(images, torch.Tensor):
        device = images.device
    if device is None:
        raise ValueError('device is required for a non-tensor batch')
    device = convert.resolve_device(device)
    if mode == 'dense':
        images = convert.to_tensor(images, device)
        shapes, canvas = _batch_canvas(plans, images, canvas_shape)
        return _dense_plan_warp(plans, images, shapes, canvas, border_value,
                                taps_max, return_maps)
    with profiling.span('plan_warp'):
        with profiling.span('plan_warp.enqueue'):
            images = convert.to_tensor(images, device)
        shapes, canvas = _batch_canvas(plans, images, canvas_shape)
        return _routed_plan_warp(plans, images, shapes, canvas, border_value,
                                 return_maps, mode)


def _batch_canvas(plans, images, canvas_shape):
    """Each plan's output shape, and the canvas that holds them all and
    at least ``canvas_shape``."""
    n = images.shape[0]
    if len(plans) != n:
        raise ValueError(f'{len(plans)} plans for a batch of {n}')
    shapes = [plan.dst_shape for plan in plans]
    h_max = max(s[0] for s in shapes)
    w_max = max(s[1] for s in shapes)
    if canvas_shape is not None:
        h_max = max(h_max, canvas_shape[0])
        w_max = max(w_max, canvas_shape[1])
    return shapes, (h_max, w_max)


def _routed_plan_warp(plans, images, shapes, canvas, border_value,
                      return_maps, mode):
    """``batched_plan_warp`` in modes ``auto`` and ``gather``."""
    span, count = profiling.span, profiling.count
    n, h_in, w_in = images.shape[:3]
    h_max, w_max = canvas

    # Per-sample partition: affine plans run the two-shear program,
    # non-affine plans (lattice fields, perspective skews) the banded one.
    with span('plan_warp.route'):
        aff_sel = np.zeros(n, dtype=bool)
        aff_mats = np.tile(np.eye(3, dtype=np.float64), (n, 1, 1))
        aff_quads = np.zeros(n, dtype=np.int8)
        if mode == 'auto':
            for i, plan in enumerate(plans):
                if plan.is_lattice:
                    continue
                mat3 = np.eye(3, dtype=np.float64)
                if plan.matrix is not None:
                    m = np.asarray(plan.matrix, dtype=np.float64)
                    mat3[:m.shape[0]] = m
                if np.abs(mat3[2, :2]).max() > 1e-9:
                    continue  # perspective (skew_hori/vert) -> banded
                aff_sel[i] = True
                aff_mats[i] = mat3
            if aff_sel.any():
                quads, reduced = quadrant_reduce_mats(
                    aff_mats[aff_sel], (h_in, w_in)
                )
                # Residual conditioning check (extreme anisotropic
                # zoom-in).
                cond = np.abs(np.linalg.inv(reduced)[:, 0, 0]) > 0.18
                sel_idx = np.flatnonzero(aff_sel)
                aff_sel[sel_idx[~cond]] = False
                keep = np.flatnonzero(cond)
                aff_quads[sel_idx[keep]] = quads[keep]
                aff_mats[sel_idx[keep]] = reduced[keep]

        aplan = None
        if mode == 'auto' and aff_sel.any():
            aff_idx = np.flatnonzero(aff_sel)
            aff_idx_p = _bucket_pad(aff_idx, n, ladder=(8, n))
            try:
                aplan, astatics = plan_affine_warp(
                    aff_mats[aff_idx_p], (h_in, w_in), (h_max, w_max),
                    canonical=True,
                )
            except AssertionError:
                # Span exceeds every shift kernel (huge canvases): the
                # whole batch takes the banded/gather routing.
                aplan = None
                aff_sel[:] = False
    if mode == 'auto' and aff_sel.any() and aplan is not None:
        coverages = LazyCoverages(plans)
        quads_p = aff_quads[aff_idx_p]
        direct = (
            len(aff_idx_p) == n and aff_sel.all()
            and np.array_equal(aff_idx_p, np.arange(n))
        )
        with span('plan_warp.enqueue'):
            wa = _affine_sub_warp(
                images, aff_idx_p, quads_p,
                convert.affine_warp_plan(aplan, images.device), astatics,
                border_value, not direct, not (quads_p == 0).all(),
            )
        count('plan_warp.samples.affine', len(aff_idx))
        if aff_sel.all():
            if return_maps:
                return wa, shapes, coverages, None
            return wa, shapes, coverages

        # Mixed batch: banded sub-program on the rest, scatter-merge.
        with span('plan_warp.route'):
            rest_idx = np.flatnonzero(~aff_sel)
            rest_idx_p = _bucket_pad(rest_idx, n)
            pad_map = np.concatenate([
                np.arange(len(rest_idx)),
                np.zeros(len(rest_idx_p) - len(rest_idx), dtype=np.int64),
            ])
            boxes = _content_boxes(plans, rest_idx)[pad_map]
        nodes_all = None
        with span('plan_warp.nodes'):
            if return_maps:
                nodes_all = _build_coarse_nodes(
                    list(plans), shapes, (h_max, w_max)
                )
                cy, cx, nys, nxs = nodes_all
                rest_nodes = (cy[rest_idx_p], cx[rest_idx_p], nys, nxs)
            else:
                rest_plans_u = [plans[i] for i in rest_idx]
                cy, cx, nys, nxs = _build_coarse_nodes(
                    rest_plans_u, [p.dst_shape for p in rest_plans_u],
                    (h_max, w_max),
                )
                rest_nodes = (cy[pad_map], cx[pad_map], nys, nxs)
        with span('plan_warp.enqueue'):
            sub_r = images[torch.as_tensor(rest_idx_p, device=images.device)]
        result = _coarse_mxu_warp(
            sub_r, rest_nodes, (h_in, w_in), (h_max, w_max),
            border_value, return_maps=False, content_boxes=boxes,
            samples=len(rest_idx),
        )
        if result is not None:
            wr = result[0]
        else:
            with span('plan_warp.enqueue'):
                wr, _ = _coarse_gather_warp(
                    sub_r, [None] * len(rest_idx_p), None, (h_max, w_max),
                    border_value, nodes=rest_nodes,
                )
            count('plan_warp.samples.gather', len(rest_idx))
        with span('plan_warp.enqueue'):
            out = _merge_subbatches(aff_idx_p, wa, rest_idx_p, wr, n)
            if return_maps:
                cy, cx, nys, nxs = nodes_all
                dev_maps = _upsample_node_maps(
                    convert.to_tensor(cy, images.device, torch.float32),
                    convert.to_tensor(cx, images.device, torch.float32),
                    _interp_weights(h_max, nys, images.device),
                    _interp_weights(w_max, nxs, images.device),
                )
        if return_maps:
            return out, shapes, coverages, dev_maps
        return out, shapes, coverages

    # Coarse-node paths: lattice maps evaluated at the nodes only, matrix
    # and nop maps analytically; coverages materialize on access.
    map_list = list(plans)
    coverages = LazyCoverages(plans)
    with span('plan_warp.nodes'):
        nodes = _build_coarse_nodes(map_list, shapes, (h_max, w_max))
    if mode != 'gather':
        with span('plan_warp.route'):
            boxes = _content_boxes(plans, range(n))
        result = _coarse_mxu_warp(
            images, nodes, (h_in, w_in), (h_max, w_max), border_value,
            return_maps, content_boxes=boxes,
        )
        if result is not None:
            warped, dev_maps = result
            if return_maps:
                return warped, shapes, coverages, dev_maps
            return warped, shapes, coverages
    with span('plan_warp.enqueue'):
        warped, dev_maps = _coarse_gather_warp(
            images, map_list, shapes, (h_max, w_max), border_value,
            nodes=nodes,
        )
    count('plan_warp.samples.gather', n)
    if return_maps:
        return warped, shapes, coverages, dev_maps
    return warped, shapes, coverages


def batched_grid_warp(
    distortion,
    configs: Sequence,
    images,
    rng=None,
    border_value: float = 0.0,
    taps_max: int = 24,
    device='cuda',
):
    """Batch one geometric distortion (per-sample configs) through the
    warp; see batched_plan_warp.  A tensor batch stays on its own device; a
    numpy batch goes to ``device`` (the CPU only when asked for)."""
    if not isinstance(images, torch.Tensor):
        images = convert.to_tensor(images, convert.resolve_device(device))
    n, h_in, w_in = images.shape[:3]
    assert len(configs) == n
    if rng is None:
        rng = np.random.default_rng(0)
    plans = [distortion.plan(cfg, (h_in, w_in), rng) for cfg in configs]
    return batched_plan_warp(plans, images, border_value, taps_max)


# ---------------------------------------------------------------------------
# The photometric catalog: batched twins of the per-element distortions on
# (N, H, W, 3) uint8 batches.
# ---------------------------------------------------------------------------


def _per_sample(values, like, dtype=torch.float32):
    """(N,) values -> (N, 1, 1, 1) tensor on ``like``'s device."""
    return convert.to_tensor(values, like.device, dtype).reshape(-1, 1, 1, 1)


def _finish(x, oob: OutOfBoundBehavior = OutOfBoundBehavior.CLIP):
    x = torch.round(x)
    if oob == OutOfBoundBehavior.CYCLE:
        return torch.remainder(x, 256.0).to(torch.uint8)
    return torch.clamp(x, 0, 255).to(torch.uint8)


def _apply_channels(images, new_channels, channels):
    if channels is None:
        return new_channels
    out = images.clone()
    out[..., list(channels)] = new_channels
    return out


def _select_channels(images, channels):
    if channels is None:
        return images
    return images[..., list(channels)]


def _generator(device, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one (seed, stream) pair.  The
    rng-consuming ops draw on the image's own device, never on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 4) | stream)
    return gen


def _records(**fields):
    """Per-sample config records from per-sample field lists, for the
    reference's host preps."""
    return [SimpleNamespace(**dict(zip(fields, values)))
            for values in zip(*fields.values())]


# Color.


def batched_mean_shift(images, deltas, thresholds=None, channels=None,
                       oob_behavior=OutOfBoundBehavior.CLIP):
    x = _select_channels(images, channels).to(torch.float32)
    d = _per_sample(deltas, x)
    if thresholds is None:
        x = x + d
    else:
        t = _per_sample(thresholds, x)
        # delta > 0 shifts dark pixels up; delta <= 0 shifts bright down.
        gate = torch.where(d > 0, x <= t, t <= x)
        x = torch.where(gate, x + d, x)
    return _apply_channels(images, _finish(x, oob_behavior), channels)


def batched_color_shift(images, deltas):
    hsv = color_ops.rgb_to_hsv_full(images).to(torch.float32)
    h = torch.remainder(hsv[..., 0] + _per_sample(deltas, hsv)[..., 0], 256.0)
    hsv = torch.cat([h[..., None], hsv[..., 1:]], dim=-1)
    return color_ops.hsv_full_to_rgb(_finish(hsv, OutOfBoundBehavior.CYCLE))


def batched_brightness_shift(images, deltas, use_hsv: bool = False):
    if use_hsv:
        inter = color_ops.rgb_to_hsv_full(images).to(torch.float32)
    else:
        inter = color_ops.rgb_to_hsl_full(images).to(torch.float32)
    v = torch.clamp(inter[..., 2] + _per_sample(deltas, inter)[..., 0], 0, 255)
    inter = _finish(torch.cat([inter[..., :2], v[..., None]], dim=-1))
    if use_hsv:
        return color_ops.hsv_full_to_rgb(inter)
    return color_ops.hsl_full_to_rgb(inter)


def batched_std_shift(images, scales, channels=None):
    x = _select_channels(images, channels).to(torch.float32)
    mean = x.mean(dim=(1, 2), keepdim=True)
    s = _per_sample(scales, x)
    x = x * s - mean * (s - 1.0)
    return _apply_channels(images, _finish(x), channels)


def batched_boundary_equalization(images, channels=None):
    x = _select_channels(images, channels).to(torch.float32)
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    delta = hi - lo
    scale = scalar(255.0, delta) / torch.clamp(delta, min=1e-6)
    stretched = torch.where(delta > 0, (x - lo) * scale, x)
    return _apply_channels(images, _finish(stretched), channels)


def batched_histogram_equalization(images, channels=None):
    x = _select_channels(images, channels)
    n, h, w, c = x.shape
    flat = x.permute(0, 3, 1, 2).reshape(n * c, h, w)
    eq = color_ops.equalize_hist_batch(flat)
    eq = eq.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return _apply_channels(images, eq, channels)


def batched_complement(images, thresholds=None, enable_threshold_ltes=False,
                       channels=None):
    x = _select_channels(images, channels).to(torch.float32)
    if thresholds is None:
        out = 255.0 - x
    else:
        t = _per_sample(thresholds, x)
        lte = _per_sample(
            np.broadcast_to(np.asarray(enable_threshold_ltes, dtype=bool),
                            (x.shape[0],)),
            x, torch.bool,
        )
        gate = torch.where(lte, x <= t, t <= x)
        out = torch.where(gate, 255.0 - x, x)
    return _apply_channels(images, _finish(out), channels)


def batched_posterization(images, num_bits, channels=None):
    x = _select_channels(images, channels).to(torch.int32)
    bits = _per_sample(num_bits, x, torch.int32)
    keep = (torch.full_like(bits, 255) >> bits) << bits
    out = torch.bitwise_and(x, keep).to(torch.uint8)
    return _apply_channels(images, out, channels)


def batched_color_balance(images, ratios):
    x = images.to(torch.float32)
    gray = color_ops.rgb_to_gray(x)[..., None]
    r = _per_sample(ratios, x)
    return _finish((1.0 - r) * gray + r * x)


def batched_channel_permutation(images, perms):
    """``perms``: (N, C) int — out channel c reads in channel perms[n, c].
    A gather, exact like the reference's one-hot contraction."""
    perms = convert.to_tensor(perms, images.device, torch.int64)
    n, h, w, c = images.shape
    return torch.gather(images, 3, perms[:, None, None, :].expand(n, h, w, c))


def _random_perms(n: int, channels: int, generator):
    """One uniformly random permutation of the channels per sample."""
    keys = torch.rand((n, channels), generator=generator,
                      device=generator.device)
    return torch.argsort(keys, dim=1)


# Noise: drawn from a torch.Generator on the images' device.


def batched_gaussion_noise(images, stds, generator):
    return noise_ops.gaussian_noise(generator, images,
                                    _per_sample(stds, images))


def batched_poisson_noise(images, generator):
    return noise_ops.poisson_noise(generator, images)


def batched_impulse_noise(images, prob_salts, prob_peppers, generator):
    return noise_ops.impulse_noise(generator, images,
                                   _per_sample(prob_salts, images),
                                   _per_sample(prob_peppers, images))


def batched_speckle_noise(images, stds, generator):
    return noise_ops.speckle_noise(generator, images,
                                   _per_sample(stds, images))


# Effect.


def _jpeg_tables(qualities):
    luma = np.stack([_quality_scaled_table(_LUMA_QTABLE, int(q))
                     for q in np.asarray(qualities)]).astype(np.int32)
    chroma = np.stack([_quality_scaled_table(_CHROMA_QTABLE, int(q))
                       for q in np.asarray(qualities)]).astype(np.int32)
    return luma, chroma


def _jpeg_bgr(images, luma, chroma):
    # BGR-compat: the reference encodes its RGB mats through cv.imencode,
    # which reads them as BGR; run the codec on reversed channels.
    device = images.device
    out = jpeg_roundtrip_exact_torch(
        images.flip(-1), convert.to_tensor(luma, device, torch.int32),
        convert.to_tensor(chroma, device, torch.int32),
    )
    return out.flip(-1)


def batched_jpeg_quality(images, qualities):
    """Per-sample qualities -> per-sample quant tables (host) -> the
    bit-exact integer libjpeg pipeline (ops/jpeg_exact.py, int32)."""
    return _jpeg_bgr(images, *_jpeg_tables(qualities))


def batched_fog(images, roughnesses, generator, fog_rgb=(226, 238, 234),
                ratio_maxs=1.0, ratio_mins=0.0):
    n, h, w = images.shape[:3]
    device = images.device
    size = int(2 ** np.ceil(np.log2(max(h, w))))

    def per_sample(values):
        return convert.to_tensor(
            np.broadcast_to(np.asarray(values, dtype=np.float32), (n,)),
            device,
        )

    masks = diamond_square_mask(generator, size,
                                per_sample(roughnesses))[:, :h, :w]
    lo = masks.amin(dim=(1, 2), keepdim=True)
    hi = masks.amax(dim=(1, 2), keepdim=True)
    masks = (masks - lo) / torch.clamp(hi - lo, min=1e-6)
    rmax = per_sample(ratio_maxs)
    rmin = per_sample(ratio_mins)
    masks = masks * (rmax - rmin)[:, None, None] + rmin[:, None, None]

    fog = convert.to_tensor(np.asarray(fog_rgb, dtype=np.float32), device)
    if fog.dim() == 2:          # per-sample colors (N, 3)
        fog = fog[:, None, None, :]
    return blend(images, fog, alpha=masks)


# Blur: host-built per-sample kernels, one grouped convolution.


def _trim_kernels(kernels) -> np.ndarray:
    """(N, K, K) kernels cropped to the narrowest centred odd window that
    holds every nonzero tap.  The reference pads kernels to a width ladder
    (keys of XLA's compile cache); the extra taps are zeros, which change
    nothing but the reflect pad, and torch's reflect mode refuses a pad as
    wide as a small image."""
    kernels = np.asarray(kernels, dtype=np.float32)
    size = kernels.shape[-1]
    center = size // 2
    taps = np.argwhere(np.any(kernels != 0, axis=0))
    half = int(np.abs(taps - center).max()) if len(taps) else 0
    window = slice(center - half, center + half + 1)
    return np.ascontiguousarray(kernels[:, window, window])


def _batched_filter2d(images, kernels):
    """Per-sample 2D kernels (N, K, K) over a uint8 batch."""
    return blur_ops.filter2d(images, _trim_kernels(kernels))


def _prep_kernels(name, records, shape):
    arrays, _ = _PREPS[name](records, shape, 0)
    return arrays['kernels']


def batched_gaussian_blur(images, sigmas):
    return _batched_filter2d(images, _prep_kernels(
        'gaussian_blur', _records(sigma=list(np.asarray(sigmas))),
        images.shape))


def batched_defocus_blur(images, radii):
    return _batched_filter2d(images, _prep_kernels(
        'defocus_blur', _records(radius=list(np.asarray(radii))),
        images.shape))


def batched_motion_blur(images, radii, angles):
    return _batched_filter2d(images, _prep_kernels(
        'motion_blur', _records(radius=list(np.asarray(radii)),
                                angle=list(np.asarray(angles))),
        images.shape))


def _permute_pixels(images, flat_idx):
    """out[n, p] = images[n, flat_idx[n, p]] over flattened pixels."""
    n, h, w, c = images.shape
    idx = convert.to_tensor(flat_idx, images.device, torch.int64)
    idx = idx.reshape(n, h * w, 1).expand(n, h * w, c)
    return torch.gather(images.reshape(n, h * w, c), 1, idx).reshape(
        n, h, w, c)


def batched_glass_blur(images, sigmas, deltas, loops, rng):
    """Gaussian blur + the iterated random pixel swaps, batched: the swap
    permutation is the per-element path's own host routine (numpy rng),
    applied on the device as one gather."""
    n, h, w = images.shape[:3]
    blurred = batched_gaussian_blur(images, sigmas)
    flat_idx = np.empty((n, h, w), dtype=np.int64)
    for i in range(n):
        pos_y, pos_x = build_glass_blur_permutation(
            (h, w), int(deltas[i]), int(loops[i]), rng
        )
        flat_idx[i] = pos_y * w + pos_x
    return _permute_pixels(blurred, flat_idx.reshape(n, h * w))


def _glass_blur_rolls(x, generator, deltas, loops, dmax: int, lmax: int):
    """Iterated lattice swaps as masked rolls (the reference's
    ``_glass_blur_rolls``): each iteration swaps a (2d+1)-strided lattice
    of pixels with a jittered neighbour within +-d; lattice spacing keeps
    the swap pairs disjoint, so each (dy, dx) jitter class applies as two
    rolls under its class mask.  Jitter draws come from ``generator``."""
    n, h, w = x.shape[:3]
    device = x.device
    py = torch.arange(h, device=device)[None, :, None]
    px = torch.arange(w, device=device)[None, None, :]
    d = convert.to_tensor(deltas, device, torch.int64)[:, None, None]
    stride = 2 * d + 1
    loops_g = convert.to_tensor(loops, device, torch.int64)[:, None, None]

    def draw(shape):
        return torch.randint(0, 1 << 30, shape, generator=generator,
                             device=device)

    for it in range(lmax):
        offs = draw((2, n, 1, 1))
        off_y = offs[0] % stride
        off_x = offs[1] % stride
        jy = draw((n, h, w)) % stride - d
        jx = draw((n, h, w)) % stride - d
        lat = (
            (py >= off_y) & (py < h - d) & ((py - off_y) % stride == 0)
            & (px >= off_x) & (px < w - d) & ((px - off_x) % stride == 0)
            & (it < loops_g)
        )
        for dy in range(-dmax, dmax + 1):
            for dx in range(-dmax, dmax + 1):
                if dy == 0 and dx == 0:
                    continue
                m_c = (
                    lat & (jy == dy) & (jx == dx)
                    & (py + dy >= 0) & (py + dy <= h - 1)
                    & (px + dx >= 0) & (px + dx <= w - 1)
                )
                m_t = torch.roll(m_c, (dy, dx), (1, 2))
                fwd = torch.roll(x, (-dy, -dx), (1, 2))
                bwd = torch.roll(x, (dy, dx), (1, 2))
                x = torch.where(m_c[..., None], fwd,
                                torch.where(m_t[..., None], bwd, x))
    return x


# Streaks: stencils blended on the device.


def _blend_streak_masks(images, masks, colors, alphas):
    """images (N,H,W,3) u8; masks (N,H,W) 0/1; colors (N,3) integral;
    alphas (N,)."""
    color = convert.to_tensor(np.asarray(colors, dtype=np.float32),
                              images.device)[:, None, None, :]
    return blend(images, color,
                 np_mask=convert.to_tensor(masks, images.device) > 0,
                 alpha=_per_sample(alphas, images))


def _dash_gate(length: int, dash_thickness, dash_gap):
    """(N, length) bool, True where the dash gap blanks a row/column
    (zero dash params -> no blanking)."""
    idx = torch.arange(length, dtype=torch.float32,
                       device=dash_thickness.device)[None, :]
    period = torch.clamp(dash_thickness + dash_gap, min=1.0)[:, None]
    gated = torch.remainder(idx, period) < dash_gap[:, None]
    enabled = ((dash_thickness > 0) & (dash_gap > 0))[:, None]
    return gated & enabled


def _apply_line_streak(images, seed, arrays, static):
    """Periodic line stencils generated on the device from index
    arithmetic, two sequential blends (line intersections blend twice)."""
    n, h, w = images.shape[:3]

    def dev(key):
        return convert.to_tensor(arrays[key], images.device)

    t = dev('thickness')
    period = torch.clamp(t + dev('gap'), min=1.0)
    cols = torch.arange(w, dtype=torch.float32, device=images.device)[None]
    rows = torch.arange(h, dtype=torch.float32, device=images.device)[None]
    vert_cols = torch.remainder(cols, period[:, None]) < t[:, None]
    hori_rows = torch.remainder(rows, period[:, None]) < t[:, None]
    dash_t, dash_g = dev('dash_thickness'), dev('dash_gap')
    dash_r = _dash_gate(h, dash_t, dash_g)
    dash_c = _dash_gate(w, dash_t, dash_g)
    vert = (vert_cols[:, None, :] & ~dash_r[:, :, None]
            & dev('enable_vert')[:, None, None])
    hori = (hori_rows[:, :, None] & ~dash_c[:, None, :]
            & dev('enable_hori')[:, None, None])
    out = _blend_streak_masks(images, vert, arrays['colors'],
                              arrays['alphas'])
    return _blend_streak_masks(out, hori, arrays['colors'], arrays['alphas'])


def _apply_rectangle_streak(images, seed, arrays, static):
    """Concentric frame stencils on the device, accumulated box by box
    (padding boxes at -1e6 add nothing)."""
    n, h, w = images.shape[:3]
    device = images.device
    t = convert.to_tensor(arrays['thickness'], device)[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    boxes = convert.to_tensor(arrays['boxes'], device)
    vert = torch.zeros((n, h, w), dtype=torch.bool, device=device)
    hori = torch.zeros_like(vert)
    live = int(np.max((np.asarray(arrays['boxes'])[..., 0] > -1e5).sum(1),
                      initial=0))
    for k in range(live):
        up, down, left, right = (
            boxes[:, k, i][:, None, None] for i in range(4)
        )
        in_up = down - t + 1.0
        in_down = up + t - 1.0
        in_left = right - t + 1.0
        in_right = left + t - 1.0
        y_band = (ys >= up) & (ys <= down)
        vert |= y_band & (((xs >= left) & (xs <= in_right))
                          | ((xs >= in_left) & (xs <= right)))
        x_core = (xs >= in_right + 1.0) & (xs <= in_left - 1.0)
        hori |= x_core & (((ys >= up) & (ys <= in_down))
                          | ((ys >= in_up) & (ys <= down)))
    dash_t = convert.to_tensor(arrays['dash_thickness'], device)
    dash_g = convert.to_tensor(arrays['dash_gap'], device)
    mask = ((vert & ~_dash_gate(h, dash_t, dash_g)[:, :, None])
            | (hori & ~_dash_gate(w, dash_t, dash_g)[:, None, :]))
    return _blend_streak_masks(images, mask, arrays['colors'],
                               arrays['alphas'])


def _apply_ellipse_streak(images, seed, arrays, static):
    """Host-rasterized ring stencils (cv2-exact), blended on the device."""
    return _blend_streak_masks(images, arrays['stencil'], arrays['colors'],
                               arrays['alphas'])


def _streak_via_prep(name, images, configs):
    arrays, static = _PREPS[name](configs, images.shape, 0)
    return _CATALOG[name](images, 0, arrays, static)


def batched_line_streak(images, configs):
    return _streak_via_prep('line_streak', images, configs)


def batched_rectangle_streak(images, configs):
    return _streak_via_prep('rectangle_streak', images, configs)


def batched_ellipse_streak(images, configs):
    return _streak_via_prep('ellipse_streak', images, configs)


def attr_evolve_streak(cfg, **kwargs):
    import attr as _attr
    return _attr.evolve(cfg, **kwargs)


# Shape-changing ops as per-sample resampling matrices.


def _nearest_up_linear_down_weights(n: int, rn):
    """(N, n, n) weights of LINEAR-downsample-to-rn composed with
    NEAREST-upsample-back (the pixelation map), per-sample ``rn`` (N,)."""
    device = rn.device
    i = torch.arange(n, device=device)[None, :]
    rn_col = rn[:, None].to(torch.int64)
    a = torch.minimum(torch.clamp((i * rn_col) // n, min=0), rn_col - 1)
    scale = scalar(float(n), rn.to(torch.float32)) / rn.to(torch.float32)
    c = (a.to(torch.float32) + 0.5) * scale[:, None] - 0.5
    base = torch.floor(c)
    w1 = (c - base)[..., None]
    idx0 = torch.clamp(base.to(torch.int64), 0, n - 1)[..., None]
    idx1 = torch.clamp(base.to(torch.int64) + 1, 0, n - 1)[..., None]
    iota = torch.arange(n, device=device)[None, None, :]
    return ((iota == idx0).to(torch.float32) * (1.0 - w1)
            + (iota == idx1).to(torch.float32) * w1)


def _apply_pixelation(images, seed, arrays, static):
    n, h, w = images.shape[:3]
    device = images.device
    r_rows = _nearest_up_linear_down_weights(
        h, convert.to_tensor(arrays['rh'], device))
    r_cols = _nearest_up_linear_down_weights(
        w, convert.to_tensor(arrays['rw'], device))
    x = images.to(torch.float32)
    x = torch.einsum('nis,nswc->niwc', r_rows, x)
    x = torch.einsum('njs,nisc->nijc', r_cols, x)
    return _finish(x)


def _cubic_crop_weights(n: int, rn):
    """(N, n, n) weights of CUBIC-upsample-to-rn composed with the centre
    crop back to n (one zoom_in_blur step), per-sample ``rn`` (N,)."""
    device = rn.device
    rn_f = rn.to(torch.float32)
    up = (rn.to(torch.int64) - n) // 2
    i = torch.arange(n, device=device)[None, :] + up[:, None]
    scale = scalar(float(n), rn_f) / rn_f
    c = (i.to(torch.float32) + 0.5) * scale[:, None] - 0.5
    base = torch.floor(c)
    iota = torch.arange(n, device=device)[None, None, :]
    acc = torch.zeros((rn.shape[0], n, n), dtype=torch.float32,
                      device=device)
    a = -0.75
    for tap in (-1, 0, 1, 2):
        idx = base.to(torch.int64) + tap
        dist = torch.abs(c - idx.to(torch.float32))
        d2 = dist * dist
        d3 = d2 * dist
        wt = torch.where(
            dist <= 1.0,
            (a + 2.0) * d3 - (a + 3.0) * d2 + 1.0,
            torch.where(
                dist < 2.0,
                a * d3 - 5.0 * a * d2 + 8.0 * a * dist - 4.0 * a,
                0.0,
            ),
        )
        clipped = torch.clamp(idx, 0, n - 1)[..., None]
        acc = acc + (iota == clipped).to(torch.float32) * wt[..., None]
    return acc / acc.sum(dim=2, keepdim=True)      # cv2 row normalization


def _apply_zoom(images, seed, arrays, static):
    """Average of the centre-cropped cubic zooms, mixed by alpha.  Steps
    past every sample's count add zero in the reference; they are skipped."""
    n, h, w = images.shape[:3]
    device = images.device
    x = images.to(torch.float32)
    acc = x
    count = convert.to_tensor(arrays['count'], device)
    for k in range(int(np.max(arrays['count'], initial=0))):
        rows = _cubic_crop_weights(
            h, convert.to_tensor(arrays['rhs'][:, k], device))
        cols = _cubic_crop_weights(
            w, convert.to_tensor(arrays['rws'][:, k], device))
        z = torch.einsum('nis,nswc->niwc', rows, x)
        z = torch.einsum('njs,nisc->nijc', cols, z)
        live = (k < count)[:, None, None, None]
        acc = acc + torch.where(live, z, 0.0)
    total = (count + 1).to(torch.float32)[:, None, None, None]
    alpha = _per_sample(arrays['alpha'], x)
    mixed = (1.0 - alpha) * x + alpha * torch.round(acc / total)
    return _finish(mixed)


# ---------------------------------------------------------------------------
# Host preps (numpy): configs -> parameter arrays and a static signature, the
# reference's own code from its compiled catalog.
# ---------------------------------------------------------------------------


# Shared blur-kernel widths: the padded width is a compiled-program
# static, and batch-max padding drew a fresh width (hence a fresh XLA
# program) nearly every randomized-policy batch.  A sparse odd ladder
# keeps the compile set tiny; extra taps are zeros (a few ms of conv).
_KERNEL_WIDTH_LADDER = (5, 9, 17, 33, 65)


def _padded_kernels(kernels):
    """Pad per-sample 2D kernels to a shared odd LADDER width."""
    ksize = max(k.shape[0] for k in kernels)
    if ksize % 2 == 0:
        ksize += 1
    for q in _KERNEL_WIDTH_LADDER:
        if ksize <= q:
            ksize = q
            break
    out = np.zeros((len(kernels), ksize, ksize), dtype=np.float32)
    for idx, k in enumerate(kernels):
        off_y = (ksize - k.shape[0]) // 2
        off_x = (ksize - k.shape[1]) // 2
        out[idx, off_y:off_y + k.shape[0], off_x:off_x + k.shape[1]] = k
    return out


def _field(configs, name):
    return [getattr(cfg, name) for cfg in configs]


def _uniform(configs, name):
    values = _field(configs, name)
    assert all(v == values[0] for v in values), (
        f'{name} must be shared across the batch for the device path'
    )
    return values[0]


def _chan(configs):
    channels = _uniform(configs, 'channels')
    return tuple(channels) if channels is not None else None


def _chan_gate3(channels) -> np.ndarray:
    """Per-channel 0/1 gate for a channels subset (None -> all)."""
    gate = np.zeros(3, dtype=np.float32)
    if channels is None:
        gate[:] = 1.0
    else:
        gate[list(channels)] = 1.0
    return gate


def _f32(values):
    return np.asarray(values, dtype=np.float32)


def _prep_mean_shift(configs, shape, key):
    deltas = _field(configs, 'delta')
    thresholds = _field(configs, 'threshold')
    arrays = {'deltas': _f32(deltas)}
    has_thresholds = not all(t is None for t in thresholds)
    if has_thresholds:
        arrays['thresholds'] = _f32([
            t if t is not None else (255 if d > 0 else 0)
            for t, d in zip(thresholds, deltas)
        ])
    return arrays, (_chan(configs), _uniform(configs, 'oob_behavior'),
                    has_thresholds)


def _prep_complement(configs, shape, key):
    ltes = _field(configs, 'enable_threshold_lte')
    thresholds = _field(configs, 'threshold')
    has_thresholds = not all(t is None for t in thresholds)
    arrays = {}
    if has_thresholds:
        arrays['thresholds'] = _f32([
            t if t is not None else (255 if lte else 0)
            for t, lte in zip(thresholds, ltes)
        ])
        arrays['ltes'] = np.asarray(ltes, dtype=bool)
    return arrays, (_chan(configs), has_thresholds)


def _prep_brightness(configs, shape, key):
    from ..element import ImageMode

    mode = _uniform(configs, 'intermediate_image_mode')
    return ({'deltas': _f32(_field(configs, 'delta'))},
            (mode == ImageMode.HSV,))


def _prep_jpeg(configs, shape, key):
    qualities = _field(configs, 'quality')
    luma = np.stack([
        _quality_scaled_table(_LUMA_QTABLE, int(q)) for q in qualities
    ]).astype(np.int32)
    chroma = np.stack([
        _quality_scaled_table(_CHROMA_QTABLE, int(q)) for q in qualities
    ]).astype(np.int32)
    return {'luma': luma, 'chroma': chroma}, ()


def _prep_fog(configs, shape, key):
    # fog_rgb rides as a traced (N, 3) array: as a static it keyed a
    # fresh compiled program on every drawn color (unbounded compile set
    # across randomized batches — the round-4 steady-state leak).
    return ({
        'roughnesses': _f32(_field(configs, 'roughness')),
        'rmax': _f32(_field(configs, 'ratio_max')),
        'rmin': _f32(_field(configs, 'ratio_min')),
        'fog_rgb': np.asarray(_field(configs, 'fog_rgb'), np.float32),
    }, ())


def _gaussian_kernels(sigmas):
    kernels = []
    for sigma in np.asarray(sigmas):
        ksize = estimate_gaussian_kernel_size(float(sigma))
        k1 = blur_ops.gaussian_kernel1d(float(sigma), ksize)
        kernels.append(np.outer(k1, k1))
    return kernels


def _prep_gaussian_blur(configs, shape, key):
    kernels = _gaussian_kernels(_field(configs, 'sigma'))
    return {'kernels': np.asarray(_padded_kernels(kernels))}, ()


def _prep_defocus_blur(configs, shape, key):
    kernels = []
    for radius in _field(configs, 'radius'):
        radius = int(radius)
        size = 2 * radius + 1
        coords = np.arange(size) - radius
        xs, ys = np.meshgrid(coords, coords)
        kernel = ((xs**2 + ys**2) <= radius**2).astype(np.float32)
        kernels.append(kernel / kernel.sum())
    return {'kernels': np.asarray(_padded_kernels(kernels))}, ()


def _prep_motion_blur(configs, shape, key):
    kernels = []
    for radius, angle in zip(_field(configs, 'radius'),
                             _field(configs, 'angle')):
        ksize = 2 * int(radius) + 1
        kernel = blur_ops.motion_line_kernel(ksize, -(float(angle) % 360))
        kernels.append(kernel / max(kernel.sum(), 1e-6))
    return {'kernels': np.asarray(_padded_kernels(kernels))}, ()


def _prep_glass_blur(configs, shape, seed):
    kernels = _gaussian_kernels(_field(configs, 'sigma'))
    deltas = np.asarray(_field(configs, 'delta'), np.int32)
    loops = np.asarray(_field(configs, 'loop'), np.int32)
    dmax = int(deltas.max())
    lmax = int(loops.max())
    if dmax <= 2 and lmax <= 8:
        return {
            'kernels': np.asarray(_padded_kernels(kernels)),
            'deltas': deltas,
            'loops': loops,
        }, ('rolls', dmax, 4 if lmax <= 4 else 8)

    # Arbitrary delta/loop: host-built permutation + device gather (the
    # gather lowers ~40x off roofline — only the long-tail configs pay).
    from .distortion.photometric.blur import build_glass_blur_permutation

    n, h, w = shape[:3]
    rng = np.random.default_rng(int(seed) & 0x7FFFFFFF)
    flat_idx = np.empty((n, h, w), dtype=np.int32)
    for i, cfg in enumerate(configs):
        pos_y, pos_x = build_glass_blur_permutation(
            (h, w), int(cfg.delta), int(cfg.loop), rng
        )
        flat_idx[i] = pos_y * w + pos_x
    return {
        'kernels': np.asarray(_padded_kernels(kernels)),
        'flat_idx': flat_idx.reshape(n, h * w),
    }, ('gather',)


def _prep_line_streak(configs, shape, key):
    return {
        'thickness': _f32(_field(configs, 'thickness')),
        'gap': _f32(_field(configs, 'gap')),
        'dash_thickness': _f32(_field(configs, 'dash_thickness')),
        'dash_gap': _f32(_field(configs, 'dash_gap')),
        'enable_vert': np.asarray(_field(configs, 'enable_vert'), bool),
        'enable_hori': np.asarray(_field(configs, 'enable_hori'), bool),
        'colors': _f32(_field(configs, 'color')),
        'alphas': _f32(_field(configs, 'alpha')),
    }, ()


def _concentric_box_array(configs, shape, max_boxes_round: int = 8):
    """(N, B, 4) float32 concentric frames (up, down, left, right), padded
    with degenerate rows; B rounds up so compile count stays bounded."""
    from .distortion.photometric.streak import concentric_boxes

    n, h, w = shape[:3]
    per_sample = []
    for cfg in configs:
        aspect = cfg.aspect_ratio if cfg.aspect_ratio is not None else w / h
        boxes = concentric_boxes(h, w, aspect, cfg.short_side_min,
                                 cfg.short_side_step)
        per_sample.append([
            (b.up, b.down, b.left, b.right) for b in boxes
        ])
    b_max = max((len(b) for b in per_sample), default=1)
    # Power-of-two padding (min one round): the box count is a compiled
    # static via the scan length.
    padded = max_boxes_round
    while padded < b_max:
        padded *= 2
    b_max = padded
    out = np.full((n, b_max, 4), -1e6, dtype=np.float32)
    for i, boxes in enumerate(per_sample):
        if boxes:
            out[i, :len(boxes)] = boxes
    return out


def _prep_rectangle_streak(configs, shape, key):
    return {
        'boxes': _concentric_box_array(configs, shape),
        'thickness': _f32(_field(configs, 'thickness')),
        'dash_thickness': _f32(_field(configs, 'dash_thickness')),
        'dash_gap': _f32(_field(configs, 'dash_gap')),
        'colors': _f32(_field(configs, 'color')),
        'alphas': _f32(_field(configs, 'alpha')),
    }, ()


def _prep_ellipse_streak(configs, shape, key):
    """Host-rasterized ring stencils (cv2-exact integer rasterization,
    ops/cvraster.py via ellipse_ring_stencil) uploaded as jit arguments —
    the device implicit-band form diverged from the cv pixel sets the
    per-element path now reproduces.  Member sub-batches keep the upload
    small (~0.4 MB per member at 640^2)."""
    from .distortion.photometric.streak import (
        concentric_boxes,
        ellipse_ring_stencil,
    )

    n, h, w = shape[:3]
    stencils = np.zeros((len(configs), h, w), dtype=np.uint8)
    for i, cfg in enumerate(configs):
        aspect = cfg.aspect_ratio if cfg.aspect_ratio is not None else w / h
        boxes = concentric_boxes(
            h, w, aspect, cfg.short_side_min, cfg.short_side_step
        )
        stencils[i] = ellipse_ring_stencil(
            (h, w), (w // 2, h // 2),
            [(b.width // 2, b.height // 2) for b in boxes],
            int(cfg.thickness),
        )
    return {
        'stencil': stencils,
        'colors': _f32(_field(configs, 'color')),
        'alphas': _f32(_field(configs, 'alpha')),
    }, ()


def _field_prep(field_names, *statics_fields):
    """Prep factory: per-sample float arrays + uniform static fields."""
    def prep(configs, shape, key):
        arrays = {
            name: _f32(_field(configs, name)) for name in field_names
        }
        static = tuple(
            tuple(v) if isinstance(v, (list, tuple)) else v
            for v in (
                _uniform(configs, f) for f in statics_fields
            )
        )
        return arrays, static
    return prep


def _prep_pixelation(configs, shape, key):
    n, h, w = shape[:3]
    rh = np.asarray([
        max(1, round(h * cfg.ratio)) for cfg in configs
    ], dtype=np.int32)
    rw = np.asarray([
        max(1, round(w * cfg.ratio)) for cfg in configs
    ], dtype=np.int32)
    return {'rh': rh, 'rw': rw}, ()


_ZOOM_MAX_STEPS = 24


def _prep_zoom(configs, shape, key):
    n, h, w = shape[:3]
    rhs = np.full((len(configs), _ZOOM_MAX_STEPS), h, dtype=np.int32)
    rws = np.full((len(configs), _ZOOM_MAX_STEPS), w, dtype=np.int32)
    counts = np.zeros(len(configs), dtype=np.int32)
    for idx, cfg in enumerate(configs):
        zooms = np.arange(1 + cfg.step, 1 + cfg.ratio + cfg.step, cfg.step)
        if len(zooms) > _ZOOM_MAX_STEPS:
            # The traced program unrolls _ZOOM_MAX_STEPS stages; deeper
            # ladders would silently diverge from the reference's full
            # average — no silent caps (the policy's level-10 maximum is
            # ratio 0.4 / step 0.02 = 20 steps, so this only fires on
            # hand-written extreme configs).
            logger.warning(
                'zoom_in_blur: ratio/step = %d zoom levels exceeds the '
                'traced maximum %d; truncating (visually equivalent, not '
                'reference-exact)', len(zooms), _ZOOM_MAX_STEPS,
            )
            zooms = zooms[:_ZOOM_MAX_STEPS]
        counts[idx] = len(zooms)
        for k, z in enumerate(zooms):
            rhs[idx, k] = round(h * z)
            rws[idx, k] = round(w * z)
    return {
        'rhs': rhs, 'rws': rws, 'count': counts,
        'alpha': _f32(_field(configs, 'alpha')),
    }, ()


# The prep of each catalog name (the reference's _COMPILED_CATALOG preps).
_PREPS = {
    'mean_shift': _prep_mean_shift,
    'color_shift': _field_prep(('delta',)),
    'brightness_shift': _prep_brightness,
    'std_shift': _field_prep(('scale',), 'channels'),
    'boundary_equalization': _field_prep((), 'channels'),
    'histogram_equalization': lambda configs, shape, key: ({
        'chan_gate': np.stack([
            _chan_gate3(getattr(c, 'channels', None)) for c in configs
        ]),
    }, ()),
    'complement': _prep_complement,
    'posterization': lambda configs, shape, key: (
        {'num_bits': np.asarray(_field(configs, 'num_bits'), np.int32)},
        (_chan(configs),),
    ),
    'color_balance': _field_prep(('ratio',)),
    'channel_permutation': _field_prep(()),
    'gaussion_noise': _field_prep(('std',)),
    'poisson_noise': _field_prep(()),
    'impulse_noise': _field_prep(('prob_salt', 'prob_pepper')),
    'speckle_noise': _field_prep(('std',)),
    'jpeg_quality': _prep_jpeg,
    'pixelation': _prep_pixelation,
    'fog': _prep_fog,
    'gaussian_blur': _prep_gaussian_blur,
    'defocus_blur': _prep_defocus_blur,
    'motion_blur': _prep_motion_blur,
    'glass_blur': _prep_glass_blur,
    'zoom_in_blur': _prep_zoom,
    'line_streak': _prep_line_streak,
    'rectangle_streak': _prep_rectangle_streak,
    'ellipse_streak': _prep_ellipse_streak,
}


# ---------------------------------------------------------------------------
# Per-name dispatch.  Each name's host prep (``_PREPS``) turns its configs
# into parameter arrays and a static signature; the apply below runs it on
# the device.  In eager PyTorch one function serves
# both of the reference's dispatches: its full / masked / sub modes, the
# 8-slot sub-batch padding and the kernel-width ladder only keyed XLA's
# compile cache.  A member sub-batch is gathered exactly, distorted and
# scattered back.
# ---------------------------------------------------------------------------


def _apply_mean_shift(images, seed, arrays, static):
    channels, oob, has_thresholds = static
    return batched_mean_shift(
        images, arrays['deltas'],
        arrays['thresholds'] if has_thresholds else None,
        channels=channels, oob_behavior=oob,
    )


def _apply_complement(images, seed, arrays, static):
    channels, has_thresholds = static
    if not has_thresholds:
        return batched_complement(images, None, channels=channels)
    return batched_complement(images, arrays['thresholds'],
                              enable_threshold_ltes=arrays['ltes'],
                              channels=channels)


def _apply_histogram_equalization(images, seed, arrays, static):
    gate = convert.to_tensor(arrays['chan_gate'], images.device)
    return torch.where(gate[:, None, None, :] > 0,
                       batched_histogram_equalization(images), images)


def _apply_channel_permutation(images, seed, arrays, static):
    gen = _generator(images.device, seed)
    return batched_channel_permutation(
        images, _random_perms(images.shape[0], images.shape[-1], gen))


def _apply_fog(images, seed, arrays, static):
    return batched_fog(
        images, arrays['roughnesses'], _generator(images.device, seed),
        fog_rgb=arrays['fog_rgb'], ratio_maxs=arrays['rmax'],
        ratio_mins=arrays['rmin'],
    )


def _apply_filter2d(images, seed, arrays, static):
    return _batched_filter2d(images, arrays['kernels'])


def _apply_glass_blur(images, seed, arrays, static):
    blurred = _batched_filter2d(images, arrays['kernels'])
    if static and static[0] == 'rolls':
        return _glass_blur_rolls(
            blurred, _generator(images.device, seed), arrays['deltas'],
            arrays['loops'], static[1], static[2],
        )
    return _permute_pixels(blurred, arrays['flat_idx'])


_CATALOG = {
    'mean_shift': _apply_mean_shift,
    'color_shift': lambda images, seed, arrays, static:
        batched_color_shift(images, arrays['delta']),
    'brightness_shift': lambda images, seed, arrays, static:
        batched_brightness_shift(images, arrays['deltas'],
                                 use_hsv=static[0]),
    'std_shift': lambda images, seed, arrays, static:
        batched_std_shift(images, arrays['scale'], channels=static[0]),
    'boundary_equalization': lambda images, seed, arrays, static:
        batched_boundary_equalization(images, channels=static[0]),
    'histogram_equalization': _apply_histogram_equalization,
    'complement': _apply_complement,
    'posterization': lambda images, seed, arrays, static:
        batched_posterization(images, arrays['num_bits'],
                              channels=static[0]),
    'color_balance': lambda images, seed, arrays, static:
        batched_color_balance(images, arrays['ratio']),
    'channel_permutation': _apply_channel_permutation,
    'gaussion_noise': lambda images, seed, arrays, static:
        batched_gaussion_noise(images, arrays['std'],
                               _generator(images.device, seed)),
    'poisson_noise': lambda images, seed, arrays, static:
        batched_poisson_noise(images, _generator(images.device, seed)),
    'impulse_noise': lambda images, seed, arrays, static:
        batched_impulse_noise(images, arrays['prob_salt'],
                              arrays['prob_pepper'],
                              _generator(images.device, seed)),
    'speckle_noise': lambda images, seed, arrays, static:
        batched_speckle_noise(images, arrays['std'],
                              _generator(images.device, seed)),
    'jpeg_quality': lambda images, seed, arrays, static:
        _jpeg_bgr(images, arrays['luma'], arrays['chroma']),
    'pixelation': _apply_pixelation,
    'fog': _apply_fog,
    'gaussian_blur': _apply_filter2d,
    'defocus_blur': _apply_filter2d,
    'motion_blur': _apply_filter2d,
    'glass_blur': _apply_glass_blur,
    'zoom_in_blur': _apply_zoom,
    'line_streak': _apply_line_streak,
    'rectangle_streak': _apply_rectangle_streak,
    'ellipse_streak': _apply_ellipse_streak,
}
assert set(_CATALOG) == set(_PREPS)

# The catalog names that draw from the device generator: the port matches
# the reference on them in distribution only.
RNG_CONSUMING = frozenset({
    'gaussion_noise', 'poisson_noise', 'impulse_noise', 'speckle_noise',
    'channel_permutation', 'fog', 'glass_blur',
})


def batch_distort_members(name: str, group, images, seed: int):
    """Apply one distortion to the (sample_idx, config) pairs of ``group``
    (sample indices ascending) and return the new batch; the other samples
    pass through unchanged.  The host prep raises AssertionError when a
    field that must be shared differs within the group.

    The prep sees the members' configs in group order, as the reference's
    sub-batch mode does; for more than 8 members of a partial batch the
    reference preps the whole batch instead, which changes only the host
    permutations of a glass_blur draw beyond the policy's range
    (delta > 2 or loop > 8)."""
    n = images.shape[0]
    idx = [sample_idx for sample_idx, _ in group]
    configs = [config for _, config in group]
    prep = _PREPS[name]
    arrays, static = prep(configs, (len(idx),) + tuple(images.shape[1:]),
                          seed)
    apply = _CATALOG[name]
    if idx == list(range(n)):
        return apply(images, seed, arrays, static)
    idx_t = torch.as_tensor(idx, device=images.device)
    res = apply(images.index_select(0, idx_t), seed, arrays, static)
    return images.index_copy(0, idx_t, res)


def batch_distort_grouped(name: str, members, images, seed: int):
    """Apply one distortion to any (sample_idx, config) pairs: the members
    that share the reference's static signature apply together, in
    signature order, and a group whose prep refuses it (a shape-static
    field outside the signature differs) applies member by member."""
    from .batched_random import _PER_SAMPLE_ONLY, _static_signature

    if name in _PER_SAMPLE_ONLY:
        groups = [[m] for m in members]
    else:
        by_sig = defaultdict(list)
        for member in members:
            by_sig[_static_signature(name, member[1])].append(member)
        groups = [by_sig[sig] for sig in sorted(by_sig)]
    for group in groups:
        try:
            images = batch_distort_members(name, group, images, seed)
        except AssertionError:
            if len(group) == 1:
                raise
            for member in group:
                images = batch_distort_members(name, [member], images, seed)
    return images


def batch_distort_images(name: str, configs: Sequence, images, seed: int = 0):
    """Apply one catalog distortion to a uint8 (N, H, W, 3) batch, one
    config per sample (the counterpart of the reference's
    ``batch_distort_images`` and ``batch_distort_images_compiled``).
    ``seed`` seeds the rng-consuming ops."""
    if len(configs) != images.shape[0]:
        raise ValueError(f'{len(configs)} configs for a batch of '
                         f'{images.shape[0]}')
    return batch_distort_members(name, list(enumerate(configs)), images,
                                 seed)


def batch_distort_images_compiled(name: str, configs: Sequence, images,
                                  seed: int = 0):
    """The reference's one-dispatch form of ``batch_distort_images``.  The
    port runs no compiled program, so it is ``batch_distort_images`` under
    the reference's name (``seed`` where the reference takes ``key``)."""
    return batch_distort_images(name, configs, images, seed)
