"""Coarse-node banded two-pass warp: the general remap of the geometric stage.

Port of vkit_tpu/ops/warp_banded.py: the device half (``_banded_pass_body``,
``_unflip_crop_body``, ``banded_warp_body``, ``apply_banded_warp``) on
tensors, and the planning (``plan_banded_warp``, ``slice_banded_plan``, the
tap ladder, ``_BASE_MAX``, ``interp_node_weights``), which is the
reference's own numpy code, so both packages route every sample the same
way.  The node-weight cache holds numpy arrays; plans become tensors
through vkit_tpu_torch.convert.banded_warp_plan.

Each pass upsamples the node positions to a full (N, L, JP) position field
with two float32 matrix products (TF32 stays off: the port never enables
``torch.backends.cuda.matmul.allow_tf32``, and float32 products on the card
then run in full precision), then resamples every line with the banded
kernel (ops/kernels.py banded_line_resample).
"""
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .kernels import banded_line_resample


# ---------------------------------------------------------------------------
# Host planning (numpy).
# ---------------------------------------------------------------------------


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _node_grid(length: int, gap: float) -> np.ndarray:
    count = max(2, int(round((length - 1) / max(gap, 1.0))) + 1)
    g = np.round(np.linspace(0, length - 1, count)).astype(np.int64)
    # Symmetric grids let per-sample axis flips reuse reversed node values.
    return np.unique(np.concatenate([g, length - 1 - g]))


def interp_node_weights(length: int, nodes: np.ndarray) -> np.ndarray:
    """(length, len(nodes)) f32 bilinear weights through node positions
    (linear extrapolation past the last node)."""
    idx = np.searchsorted(nodes, np.arange(length), side='right') - 1
    idx = np.clip(idx, 0, len(nodes) - 2)
    left = nodes[idx]
    right = nodes[idx + 1]
    t = (np.arange(length) - left) / np.maximum(right - left, 1)
    weights = np.zeros((length, len(nodes)), dtype=np.float32)
    rows = np.arange(length)
    weights[rows, idx] = 1.0 - t
    weights[rows, idx + 1] = t
    return weights


def _interp_nodes_sparse(node_l: np.ndarray, lines: int,
                         values: np.ndarray) -> np.ndarray:
    """Linear interp of per-node ``values`` (N, R, B) to full line
    resolution -> (N, lines, B).  Equivalent to einsum with
    interp_node_weights but exploits the 2-sparse rows directly (the
    dense einsum was the planning hot spot)."""
    idx = np.searchsorted(node_l, np.arange(lines), side='right') - 1
    idx = np.clip(idx, 0, len(node_l) - 2)
    left = node_l[idx]
    right = node_l[idx + 1]
    t = ((np.arange(lines) - left)
         / np.maximum(right - left, 1))[None, :, None]
    return values[:, idx, :] * (1.0 - t) + values[:, idx + 1, :] * t


_NODE_W_CACHE = {}


def _cached_node_weights(length: int, nodes: np.ndarray):
    """interp_node_weights, cached by (length, grid) as host numpy (the
    plan moves to a device in vkit_tpu_torch.convert)."""
    key = (length, np.asarray(nodes).tobytes())
    cached = _NODE_W_CACHE.get(key)
    if cached is None:
        cached = interp_node_weights(
            length, np.asarray(nodes, dtype=np.float64)
        )
        if len(_NODE_W_CACHE) > 64:
            _NODE_W_CACHE.clear()
        _NODE_W_CACHE[key] = cached
    return cached


def _bracket_rows(values, queries):
    """For monotone-increasing ``values`` (N, R, Q) and ``queries``
    (N, R, U), the index q of the bracketing segment
    [values[..., q], values[..., q+1]].

    One flat searchsorted over row-offset-shifted values — O(NRU log Q)
    instead of the (N, R, Q, U) comparison tensor (which was ~130 MB and
    the dominant planning cost at batch 24)."""
    n, r, q = values.shape
    u = queries.shape[2]
    lo = min(values.min(), queries.min())
    hi = max(values.max(), queries.max())
    span = (hi - lo) * 2 + 1.0
    row_off = (np.arange(n * r, dtype=np.float64) * span).reshape(n, r, 1)
    flat_vals = (values - lo + row_off).ravel()
    flat_q = (queries - lo + row_off).ravel()
    idx = np.searchsorted(flat_vals, flat_q, side='right')
    idx = idx.reshape(n, r, u) - np.arange(n * r).reshape(n, r, 1) * q - 1
    return np.clip(idx, 0, q - 2)


def _interp_rows(values, grid, queries):
    """Evaluate per-row piecewise-linear curves (grid -> values) at query
    positions, extrapolating linearly from the edge segments.

    ``values``: (N, R, Q) row curves over the SHARED sorted ``grid`` (Q,);
    ``queries``: (N, R, U)."""
    q = len(grid)
    idx = np.clip(
        np.searchsorted(grid, queries.ravel(), side='right') - 1, 0, q - 2
    ).reshape(queries.shape)
    g0 = grid[idx]
    g1 = grid[idx + 1]
    v0 = np.take_along_axis(values, idx, axis=2)
    v1 = np.take_along_axis(values, idx + 1, axis=2)
    t = (queries - g0) / np.maximum(g1 - g0, 1e-9)
    return v0 + t * (v1 - v0)


class BandedPassPlan(NamedTuple):
    base: np.ndarray      # (N, L, JP/128) int32 per-(line, block) bases
    nodes: np.ndarray     # (N, Rl, Rj) f32 node positions
    w_l: np.ndarray       # (L, Rl) f32 upsample weights over lines
    w_j: np.ndarray       # (JP, Rj) f32 upsample weights over outputs


class BandedWarpPlan(NamedTuple):
    pass_v: BandedPassPlan
    pass_h: BandedPassPlan


# The banded kernel's VMEM scratch window is 2048 lanes with the source
# row placed at offset 512 (pallas_kernels._banded_resample_kernel); a
# block reads lanes [base, base + 128 + taps) without wrap only for
# base in [-512, 2048 - 512 - 256].  Bases beyond _BASE_MAX cannot be
# served (they would silently emit zero: all hat weights vanish after
# clamping) — the planner flags such samples so callers reject them to
# the gather fallback.
_BASE_MAX = 1280


def plan_banded_pass(
    nodes_pos: np.ndarray,
    node_l: np.ndarray,
    node_j: np.ndarray,
    out_len: int,
    lines: int,
    valid: Optional[np.ndarray] = None,
    in_len: Optional[int] = None,
):
    """Per-(line, block) integer bases + per-sample tap needs for one pass.

    ``nodes_pos``: (N, Rl, Rj) float64 — source positions at node lines
    ``node_l`` and node output indices ``node_j`` (spanning
    [0, out_len-1]).  Positions between nodes are bilinear (the device
    upsample), so node-level bounds hold at full resolution up to fixed
    margins.  ``valid`` marks node positions whose output is consumed;
    unconsumed positions (canvas-edge extensions outside the active
    content) are excluded from the tap bounds.

    Returns (base (N, L, JP/128) int64, needs (N,), jp, over (N,) bool).
    ``over`` marks samples whose consumed content needs bases beyond the
    kernel's window (sources longer than _BASE_MAX px on this axis) —
    the banded pass would silently zero that content, so callers must
    reject them.  Only possible when ``in_len`` exceeds _BASE_MAX;
    shorter sources never set it (pre-clip excursions there come from
    edge extrapolation in unconsumed regions, clamped harmlessly).
    """
    n, rl, rj = nodes_pos.shape
    node_l = np.asarray(node_l, dtype=np.int64)
    node_j = np.asarray(node_j, dtype=np.int64)
    jp = _round_up(out_len, 128)
    nblk = jp // 128
    gap = int(np.diff(node_j).max())

    base_nodes = np.empty((n, rl, nblk))
    span_max = np.zeros((n, rl))
    for blk in range(nblk):
        j0 = blk * 128
        sel = np.flatnonzero(
            (node_j >= j0 - gap) & (node_j <= j0 + 127 + gap)
        )
        if len(sel) == 0:
            sel = np.asarray([rj - 1])
        dev = nodes_pos[:, :, sel] - (node_j[sel] - j0)[None, None, :]
        if valid is not None:
            v = valid[:, :, sel]
            masked = np.where(v, dev, np.nan)
            with np.errstate(all='ignore'), warnings.catch_warnings():
                warnings.simplefilter('ignore', RuntimeWarning)
                lo = np.nanmin(masked, axis=2)
                hi = np.nanmax(masked, axis=2)
            dead = np.isnan(lo)
            fallback = dev.min(axis=2)
            lo = np.where(dead, fallback, lo)
            hi = np.where(dead, fallback, hi)
        else:
            lo = dev.min(axis=2)
            hi = dev.max(axis=2)
        base_nodes[:, :, blk] = lo
        span_max = np.maximum(span_max, hi - lo)

    # Bases per 8-LINE GROUP (the kernel's scalar-prefetch array must fit
    # SMEM): linear interp of the node-line minima to full resolution
    # (convex combinations keep the lower bound), min over each group,
    # floored + margin.  The intra-group drift lands in the tap margin.
    base_full = _interp_nodes_sparse(
        node_l.astype(np.float64), lines, base_nodes
    )
    groups = -(-lines // 8)
    pad = groups * 8 - lines
    if pad:
        base_full = np.concatenate(
            [base_full, np.repeat(base_full[:, -1:], pad, axis=1)], axis=1
        )
    drift = base_full.reshape(n, groups, 8, nblk)
    base = np.floor(drift.min(axis=2)).astype(np.int64) - 2
    if in_len is not None and in_len > _BASE_MAX:
        over = base.max(axis=(1, 2)) > _BASE_MAX
    else:
        over = np.zeros(n, dtype=bool)
    base = np.clip(base, -500, _BASE_MAX)
    group_drift = (drift.max(axis=2) - drift.min(axis=2)).max(axis=(1, 2))
    needs = np.ceil(span_max.max(axis=1) + group_drift) + 6
    return base, needs, jp, over


def _quantize_taps(taps: int) -> int:
    """Coarse ladder — each value is a distinct compiled program.  Taps
    are nearly free in the kernel (~0.14ms per tap per 32-batch pass), so
    the ladder runs high (the band must cover |slope - 1| * 128 for the
    pass's local axis scale, which reaches ~100 for strong rotations) and
    SPARSE: randomized-policy workloads draw a new tap need every batch,
    and each ladder rung is a fresh XLA program — three rungs keep the
    compile set tiny at a few ms of extra tap work per step."""
    for q in (32, 64, 128):
        if taps <= q:
            return q
    return taps


def plan_banded_warp(
    coarse_y: np.ndarray,
    coarse_x: np.ndarray,
    node_ys: np.ndarray,
    node_xs: np.ndarray,
    src_shape: Tuple[int, int],
    dst_shape: Tuple[int, int],
    taps_max: int = 128,
    content_boxes: Optional[np.ndarray] = None,
    fold_policy: str = 'reject',
):
    """Plan the banded two-pass warp from NODE backward maps.

    Returns (BandedWarpPlan, taps, rejects, flips, needs): ``rejects``
    lists sample indices the decomposition cannot serve (fold-over rows,
    or per-block deviation beyond ``taps_max`` — extreme zooms); their
    plan rows hold identity placeholders and callers overwrite their
    outputs with the gather fallback.  ``needs`` (N,) are the per-sample
    tap requirements — callers may slice the plan (slice_banded_plan)
    into tap-homogeneous groups and run each at its own quantized tap
    count.  Returns None when every sample rejects.

    ``content_boxes`` ((N, 4) int: up, down, left, right in dst coords):
    active-content boxes.  Rows/cols outside carry border-extension
    values whose output is contractually undefined unless masked — they
    are excluded from the tap bounds.
    """
    h_in, w_in = src_shape
    h_out, w_out = dst_shape
    coarse_y = np.asarray(coarse_y, dtype=np.float64)
    coarse_x = np.asarray(coarse_x, dtype=np.float64)
    n, r, q = coarse_x.shape
    node_xs = np.asarray(node_xs, dtype=np.float64)
    node_ys = np.asarray(node_ys, dtype=np.float64)
    node_ys_i = node_ys.astype(np.int64)
    node_xs_i = node_xs.astype(np.int64)

    ok = np.ones(n, dtype=bool)
    if content_boxes is None:
        row_content = np.ones((n, r), dtype=bool)
        col_content = np.ones((n, q), dtype=bool)
    else:
        cb = np.asarray(content_boxes, dtype=np.int64)
        row_content = (
            (node_ys_i[None, :] >= cb[:, 0:1] - 8)
            & (node_ys_i[None, :] <= cb[:, 1:2] + 8)
        )
        col_content = (
            (node_xs_i[None, :] >= cb[:, 2:3] - 8)
            & (node_xs_i[None, :] <= cb[:, 3:4] + 8)
        )
        thin = (row_content.sum(axis=1) < 2) | (col_content.sum(axis=1) < 2)
        row_content[thin] = True
        col_content[thin] = True

    # Direction sign per sample.  Fold-overs (non-monotone map_x rows)
    # break the two-pass decomposition; under ``fold_policy='reject'``
    # significant folds reject the sample, under ``'monotonize'`` the rows
    # clamp to their running max (a flat smear across the folded patch —
    # the fold region's output is geometrically ill-defined for a
    # separable decomposition either way, and the active mask usually
    # excludes it).
    sign = np.where(
        coarse_x[:, :, -1].mean(axis=1) >= coarse_x[:, :, 0].mean(axis=1),
        1.0, -1.0,
    )
    node_gap = float(np.diff(node_xs).max())
    if fold_policy == 'reject':
        dxn = np.diff(coarse_x * sign[:, None, None], axis=2) / np.maximum(
            np.diff(node_xs), 1.0
        )
        ok &= dxn.min(axis=(1, 2)) > -0.5 / max(node_gap, 1.0)
    cxs = np.maximum.accumulate(coarse_x * sign[:, None, None], axis=2)

    # Pass V positions: invert each (signed) map_x node row at the
    # src-column grid and evaluate map_y there — the classic two-pass
    # intermediate g(y, u) with map_x(y, x*) = u.
    u_nodes = _node_grid(w_in, node_gap)
    u_vals = u_nodes.astype(np.float64)
    uq = np.broadcast_to(
        sign[:, None, None] * u_vals[None, None, :], (n, r, len(u_nodes))
    )
    idx = _bracket_rows(cxs, uq)
    c0 = np.take_along_axis(cxs, idx, axis=2)
    c1 = np.take_along_axis(cxs, idx + 1, axis=2)
    t = (uq - c0) / np.maximum(c1 - c0, 1e-9)
    x_star = node_xs[idx] + t * (node_xs[idx + 1] - node_xs[idx])
    g = _interp_rows(coarse_y, node_xs, x_star)          # (N, R, U)
    pos_v_nodes = np.ascontiguousarray(g.transpose(0, 2, 1))  # (N, U, Ry)

    # Per-sample axis FLIPS normalize decreasing passes (rotations past
    # 90 degrees, vertical mirrors): the pass plans on the flipped output
    # axis (node grids are symmetric, so flipped node values are just the
    # reversed arrays) and the device un-flips the result.  Without this
    # a decreasing axis costs |slope - 1| * 128 > 128 taps.
    flip_v = (
        pos_v_nodes[:, :, -1].mean(axis=1) < pos_v_nodes[:, :, 0].mean(axis=1)
    )
    flip_h = sign < 0
    pos_v_eff = np.where(
        flip_v[:, None, None], pos_v_nodes[:, :, ::-1], pos_v_nodes
    )
    # Pass H consumes pass V's (possibly row-flipped) output rows.
    ch = np.where(flip_v[:, None, None], coarse_x[:, ::-1, :], coarse_x)
    ch_eff = np.where(flip_h[:, None, None], ch[:, :, ::-1], ch)

    rc_v = np.where(flip_v[:, None], row_content[:, ::-1], row_content)
    valid_v = np.broadcast_to(rc_v[:, None, :], pos_v_eff.shape)
    cc_h = np.where(flip_h[:, None], col_content[:, ::-1], col_content)
    valid_h = rc_v[:, :, None] & cc_h[:, None, :]

    base_v, needs_v, jp_v, over_v = plan_banded_pass(
        pos_v_eff, u_nodes, node_ys_i, h_out, w_in, valid=valid_v,
        in_len=h_in,
    )
    base_h, needs_h, jp_h, over_h = plan_banded_pass(
        ch_eff, node_ys_i, node_xs_i, w_out, jp_v, valid=valid_h,
        in_len=w_in,
    )
    ok &= ~(over_v | over_h)
    needs = np.maximum(needs_v, needs_h)
    global _LAST_NEEDS
    _LAST_NEEDS = needs.copy()  # diagnostic (profiling probes)
    ok &= needs <= taps_max
    rejects = np.flatnonzero(~ok)
    if not ok.any():
        return None
    taps = _quantize_taps(int(needs[ok].max()))

    # Identity placeholders for rejected samples keep the batch program
    # well-formed (their outputs are overwritten by the gather fallback).
    if len(rejects):
        pos_v_eff = pos_v_eff.copy()
        pos_v_eff[rejects] = node_ys[None, None, :] * (
            (h_in - 1) / max(h_out - 1, 1)
        )
        ch_eff = ch_eff.copy()
        ch_eff[rejects] = node_xs[None, None, :] * (
            (w_in - 1) / max(w_out - 1, 1)
        )
        bv, _, _, _ = plan_banded_pass(
            pos_v_eff[rejects], u_nodes, node_ys_i, h_out, w_in
        )
        bh, _, _, _ = plan_banded_pass(
            ch_eff[rejects], node_ys_i, node_xs_i, w_out, jp_v
        )
        base_v[rejects] = bv
        base_h[rejects] = bh

    # Per-DRAW arrays (bases, node positions) stay plain numpy: jit call
    # arguments transfer in one batch, eager asarray would round-trip per
    # array.  The upsample weight matrices are canvas-determined, so they
    # cache as DEVICE-RESIDENT constants across batches.
    plan = BandedWarpPlan(
        pass_v=BandedPassPlan(
            base=base_v.astype(np.int32),
            nodes=pos_v_eff.astype(np.float32),
            w_l=_cached_node_weights(w_in, u_nodes),
            w_j=_cached_node_weights(jp_v, node_ys),
        ),
        pass_h=BandedPassPlan(
            base=base_h.astype(np.int32),
            nodes=ch_eff.astype(np.float32),
            # Pass-H lines are pass V's PADDED output rows.
            w_l=_cached_node_weights(jp_v, node_ys),
            w_j=_cached_node_weights(_round_up(w_out, 128), node_xs),
        ),
    )
    return plan, taps, rejects, (flip_v, flip_h), needs


def slice_banded_plan(plan: BandedWarpPlan, idx: np.ndarray):
    """Row-slice a banded plan to a sample subset (host numpy views; the
    upsample weight matrices are sample-independent and shared)."""
    return BandedWarpPlan(
        pass_v=plan.pass_v._replace(
            base=plan.pass_v.base[idx], nodes=plan.pass_v.nodes[idx]
        ),
        pass_h=plan.pass_h._replace(
            base=plan.pass_h.base[idx], nodes=plan.pass_h.nodes[idx]
        ),
    )


# ---------------------------------------------------------------------------
# Device half.
# ---------------------------------------------------------------------------


def _banded_pass_body(x, plan: BandedPassPlan, taps: int,
                      border_value: float, pre=None, post=None):
    if pre is not None:
        x = x.permute(pre)
    # pos[n, l, j] = sum_{r, q} w_l[l, r] nodes[n, r, q] w_j[j, q].
    pos = torch.matmul(torch.matmul(plan.w_l, plan.nodes), plan.w_j.T)
    out = banded_line_resample(
        x.contiguous(), plan.base, pos.contiguous(), taps,
        border_value=border_value,
    )
    if post is not None:
        out = out.permute(post)
    return out


def _flip_mask(flags, device):
    return torch.as_tensor(flags, dtype=torch.bool,
                           device=device)[:, None, None, None]


def _unflip_crop_body(out, flip_v, flip_h, h_out: int, w_out: int):
    # Flipped samples carry their content in [0, h_out) of the FLIPPED
    # padded axis; reversing the padded axis puts it at [jp - h_out, jp),
    # the roll brings it back to the front.
    rev = torch.roll(out.flip(1), h_out - out.shape[1], dims=1)
    out = torch.where(_flip_mask(flip_v, out.device), rev, out)[:, :h_out]
    rev = torch.roll(out.flip(2), w_out - out.shape[2], dims=2)
    out = torch.where(_flip_mask(flip_h, out.device), rev, out)[:, :, :w_out]
    return out


def banded_warp_body(images, plan: BandedWarpPlan, dst_shape: Tuple[int, int],
                     taps: int, flips=None, border_value: float = 0.0):
    """Both banded passes + the unflip crop: (N, H, W, C) ->
    (N, H', W', C) float32.  ``plan`` holds tensors on ``images``' device
    (convert.banded_warp_plan); ``flips``: per-sample (flip_rows,
    flip_cols) host bool arrays from the planner."""
    h_out, w_out = tuple(dst_shape)
    had_c = images.dim() == 4
    if not had_c:
        images = images[..., None]
    x = images.to(torch.float32)

    tmp = _banded_pass_body(
        x, plan.pass_v, taps, border_value,
        pre=(0, 2, 3, 1),                  # (N, W_in, C, H_in): j = dst rows
    )                                      # (N, W_in, C, JP_v)
    out = _banded_pass_body(
        tmp, plan.pass_h, taps, border_value,
        pre=(0, 3, 2, 1),                  # (N, JP_v, C, W_in): j = dst cols
        post=(0, 1, 3, 2),                 # (N, JP_v, JP_h, C)
    )
    if flips is not None:
        out = _unflip_crop_body(out, flips[0], flips[1], h_out, w_out)
    else:
        out = out[:, :h_out, :w_out]
    if not had_c:
        out = out[..., 0]
    return out


# The reference's ``apply_banded_warp`` jit-compiles ``banded_warp_body``
# as one program; run eagerly, the body is the entry point.
apply_banded_warp = banded_warp_body
