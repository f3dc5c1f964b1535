"""Batched geometric warp: every sample by its own WarpPlan, on the device.

Port of the geometric half of vkit_tpu/mechanism/batched.py: the device
helpers ``_coarse_gather_remap``, ``_coarse_gather_warp``,
``_upsample_node_maps``, ``_scatter_samples``, ``_banded_group_scatter``,
``_merge_subbatches``, ``_affine_sub_warp``, ``_mean_pool2`` and
``_coarse_mxu_warp``, and ``batched_plan_warp`` in modes ``auto`` and
``gather``.  The host side (``_build_coarse_nodes``, ``_bucket_pad``,
``LazyCoverages``, the affine / banded / gather routing, the plans) is the
reference's own code, imported from vkit_tpu, so both packages send every
sample down the same route.  Scatters write in place into the output batch
where the reference donated its buffer.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vkit_tpu.mechanism.batched import (
    LazyCoverages,
    _bucket_pad,
    _build_coarse_nodes,
)
from vkit_tpu.mechanism.distortion.warp_plan import plan_content_box
from vkit_tpu.ops.warp_banded import (
    _quantize_taps,
    interp_node_weights,
    plan_banded_warp,
    slice_banded_plan,
)
from vkit_tpu.ops.warp_mxu import plan_affine_warp, quadrant_reduce_mats

from .. import convert
from ..ops.warp import remap_f32, to_image_dtype
from ..ops.warp_banded import apply_banded_warp, banded_warp_body
from ..ops.warp_mxu import apply_affine_warp, apply_affine_warp_quad


def _interp_weights(length: int, nodes: np.ndarray, device) -> torch.Tensor:
    """(length, len(nodes)) float32 bilinear weights through node rows
    (the numbers of the reference's ``_interp_weights``, built by its
    numpy twin ``interp_node_weights``)."""
    return convert.to_tensor(
        interp_node_weights(length, np.asarray(nodes)), device, torch.float32
    )


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


def _mean_pool2(x):
    """(N, H, W, ...) -> (N, H/2, W/2, ...) 2x2 mean pool."""
    return (
        x[:, 0::2, 0::2] + x[:, 1::2, 0::2]
        + x[:, 0::2, 1::2] + x[:, 1::2, 1::2]
    ) * 0.25


def _coarse_mxu_warp(images, nodes, src_shape, canvas, border_value,
                     return_maps: bool, content_boxes=None):
    """Banded two-pass warp from node maps; samples the decomposition
    rejects run the 2x-downscale tail or the gather program as a
    sub-batch and overwrite their rows.  Returns None only when every
    sample rejects."""
    coarse_y, coarse_x, ys, xs = nodes
    n = len(coarse_y)
    device = images.device
    planned = plan_banded_warp(
        coarse_y, coarse_x, ys, xs, src_shape, canvas,
        content_boxes=content_boxes,
    )
    if planned is None:
        return None
    plan, taps, rejects, flips, needs = planned

    orig_dtype = images.dtype
    x = images.to(torch.float32)

    reject_set = set(int(r) for r in rejects)
    acc = np.asarray(
        [i for i in range(n) if i not in reject_set], dtype=np.int64
    )
    groups = [(acc, _quantize_taps(int(needs[acc].max())))] \
        if len(acc) else []

    if len(groups) == 1 and len(groups[0][0]) == n:
        warped = apply_banded_warp(
            x, convert.banded_warp_plan(plan, device), canvas, groups[0][1],
            flips=flips, border_value=border_value,
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
        ridx = _bucket_pad(rejects, n, ladder=(8, 16))
        done = False
        h2, w2 = src_shape[0] // 2, src_shape[1] // 2
        if src_shape[0] % 2 == 0 and src_shape[1] % 2 == 0:
            # 2x-downscale tail for extreme zooms: a mean-pool prefilter
            # halves every slope and the halved field re-plans under the
            # tap ladder (half-pixel centers: s -> 0.5 * s - 0.25).
            planned2 = plan_banded_warp(
                coarse_y[ridx] * 0.5 - 0.25, coarse_x[ridx] * 0.5 - 0.25,
                ys, xs, (h2, w2), canvas,
                content_boxes=(None if content_boxes is None
                               else content_boxes[ridx]),
            )
            if planned2 is not None and len(planned2[2]) == 0:
                plan2, taps2, _, flips2, _ = planned2
                sub_half = _mean_pool2(
                    x[torch.as_tensor(ridx, device=device)]
                )
                res = apply_banded_warp(
                    sub_half, convert.banded_warp_plan(plan2, device),
                    canvas, taps2, flips=flips2, border_value=border_value,
                )
                warped = _scatter_samples(warped, ridx, res)
                done = True
        if not done:
            # Gather fallback (fold-overs the half-res plan still rejects).
            sub = x[torch.as_tensor(ridx, device=device)]
            sub_nodes = (coarse_y[ridx], coarse_x[ridx], ys, xs)
            res, _ = _coarse_gather_warp(
                sub, [None] * len(ridx), None, canvas, border_value,
                nodes=sub_nodes,
            )
            warped = _scatter_samples(warped, ridx, res)

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
      3. fields the banded plan rejects -> the 2x-downscale tail or the
         bilinear-gather program.
    ``mode='gather'`` forces 3 for every sample.  ``mode='dense'`` (the
    reference's legacy full-resolution two-pass) is not ported yet.

    Returns (warped (N, Hmax, Wmax, C) with the input dtype, result_shapes,
    coverages); with ``return_maps`` also the device (map_ys, map_xs), or
    None when every sample ran the affine route.  Pixels outside a sample's
    coverage are undefined, as in the reference: gate by the active mask.
    ``taps_max`` only applies to the dense mode; it is kept for signature
    parity.
    """
    if mode == 'dense':
        raise NotImplementedError(
            "batched_plan_warp(mode='dense') is not ported yet: the legacy "
            'dense two-pass is item 11 of ROADMAP.md'
        )
    if mode not in ('auto', 'gather'):
        raise ValueError(f'unknown mode {mode!r}')
    if device is None and isinstance(images, torch.Tensor):
        device = images.device
    if device is None:
        raise ValueError('device is required for a non-tensor batch')
    images = convert.to_tensor(images, convert.resolve_device(device))

    n, h_in, w_in = images.shape[:3]
    if len(plans) != n:
        raise ValueError(f'{len(plans)} plans for a batch of {n}')

    shapes = [plan.dst_shape for plan in plans]
    h_max = max(s[0] for s in shapes)
    w_max = max(s[1] for s in shapes)
    if canvas_shape is not None:
        h_max = max(h_max, canvas_shape[0])
        w_max = max(w_max, canvas_shape[1])

    # Per-sample partition: affine plans run the two-shear program,
    # non-affine plans (lattice fields, perspective skews) the banded one.
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
            # Residual conditioning check (extreme anisotropic zoom-in).
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
            # Span exceeds every shift kernel (huge canvases): the whole
            # batch takes the banded/gather routing.
            aplan = None
            aff_sel[:] = False
    if mode == 'auto' and aff_sel.any() and aplan is not None:
        coverages = LazyCoverages(plans)
        quads_p = aff_quads[aff_idx_p]
        direct = (
            len(aff_idx_p) == n and aff_sel.all()
            and np.array_equal(aff_idx_p, np.arange(n))
        )
        wa = _affine_sub_warp(
            images, aff_idx_p, quads_p,
            convert.affine_warp_plan(aplan, images.device), astatics,
            border_value, not direct, not (quads_p == 0).all(),
        )
        if aff_sel.all():
            if return_maps:
                return wa, shapes, coverages, None
            return wa, shapes, coverages

        # Mixed batch: banded sub-program on the rest, scatter-merge.
        rest_idx = np.flatnonzero(~aff_sel)
        rest_idx_p = _bucket_pad(rest_idx, n)
        pad_map = np.concatenate([
            np.arange(len(rest_idx)),
            np.zeros(len(rest_idx_p) - len(rest_idx), dtype=np.int64),
        ])
        nodes_all = None
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
        boxes = _content_boxes(plans, rest_idx)[pad_map]
        sub_r = images[torch.as_tensor(rest_idx_p, device=images.device)]
        result = _coarse_mxu_warp(
            sub_r, rest_nodes, (h_in, w_in), (h_max, w_max),
            border_value, return_maps=False, content_boxes=boxes,
        )
        if result is not None:
            wr = result[0]
        else:
            wr, _ = _coarse_gather_warp(
                sub_r, [None] * len(rest_idx_p), None, (h_max, w_max),
                border_value, nodes=rest_nodes,
            )
        out = _merge_subbatches(aff_idx_p, wa, rest_idx_p, wr, n)
        if return_maps:
            cy, cx, nys, nxs = nodes_all
            dev_maps = _upsample_node_maps(
                convert.to_tensor(cy, images.device, torch.float32),
                convert.to_tensor(cx, images.device, torch.float32),
                _interp_weights(h_max, nys, images.device),
                _interp_weights(w_max, nxs, images.device),
            )
            return out, shapes, coverages, dev_maps
        return out, shapes, coverages

    # Coarse-node paths: lattice maps evaluated at the nodes only, matrix
    # and nop maps analytically; coverages materialize on access.
    map_list = list(plans)
    coverages = LazyCoverages(plans)
    nodes = _build_coarse_nodes(map_list, shapes, (h_max, w_max))
    if mode != 'gather':
        result = _coarse_mxu_warp(
            images, nodes, (h_in, w_in), (h_max, w_max), border_value,
            return_maps, content_boxes=_content_boxes(plans, range(n)),
        )
        if result is not None:
            warped, dev_maps = result
            if return_maps:
                return warped, shapes, coverages, dev_maps
            return warped, shapes, coverages
    warped, dev_maps = _coarse_gather_warp(
        images, map_list, shapes, (h_max, w_max), border_value, nodes=nodes,
    )
    if return_maps:
        return warped, shapes, coverages, dev_maps
    return warped, shapes, coverages
