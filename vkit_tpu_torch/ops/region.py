"""Batched device forms of the text-region hot loops.

Port of vkit_tpu/ops/region.py.  The host planners (``plan_region_flatten``,
``region_flatten_point_map``, ``plan_char_heatmap_mats``) are the
reference's own numpy code.  The device halves run on tensors:

  - ``batch_flatten_regions``: rotate + resize of every region patch as one
    affine matrix per region through the two-shear warp (ops/warp_mxu.py,
    on the row-shift kernels of ops/kernels.py);
  - ``char_heatmap_tiles`` / ``batch_char_heatmaps``: the gaussian bump of
    each char evaluated analytically at the inverse-homography coordinates;
  - ``gather_region_windows``: every region's source patch cut out of the
    warped page batch on the device and masked to its word polygon.

The reference pads its row counts to powers of two so that XLA compiles a
bounded set of programs; eager PyTorch compiles nothing, so the device
halves here take exactly the rows they are given.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert

# Char tiles evaluated per pass of char_heatmap_tiles (bounds the float32
# temporaries at tile 64 to 64 MB each).
_HEATMAP_CHUNK = 4096


# ---------------------------------------------------------------------------
# Region flatten: rotate-to-horizontal + resize, one affine program.
# ---------------------------------------------------------------------------


def plan_region_flatten(
    angles_deg: Sequence[float],
    scales: Sequence[float],
    src_tile: int,
    dst_tile: int,
    content_extents: Optional[np.ndarray] = None,
):
    """Per-region forward mats: scale about the ROTATED content origin.

    Each region patch lives in the top-left of its (src_tile, src_tile)
    canvas; the region rotates by its flattening angle about the canvas
    center, then translates so the rotated CONTENT bounding box's corner
    sits at the dst origin, then scales — the flatten-trim-resize chain
    of FlattenedTextRegion composed into one resampling pass.

    ``content_extents``: optional (R, 2) int (h, w) — each region's real
    content extent inside its padded square tile (default: the full
    tile).  The translation zeroes the rotated CONTENT bbox, so smaller
    regions land at the dst origin instead of floating inside the
    rotated-canvas bbox.

    Returns (mats (R, 3, 3) float64, out_extents (R, 2) int (h, w): the
    rotated + scaled content extent inside the dst tile).
    """
    angles = np.asarray(angles_deg, dtype=np.float64)
    scales_np = np.asarray(scales, dtype=np.float64)
    n = len(angles)
    c = (src_tile - 1) / 2.0
    rad = np.deg2rad(angles)
    cos = np.cos(rad)
    sin = np.sin(rad)

    if content_extents is None:
        hw = np.full((n, 2), src_tile, dtype=np.float64)
    else:
        hw = np.asarray(content_extents, dtype=np.float64)
    # Content rect corners per region, (R, 4, 2) xy.
    zeros = np.zeros(n)
    ws = hw[:, 1] - 1.0
    hs = hw[:, 0] - 1.0
    corners = np.stack([
        np.stack([zeros, zeros], axis=1),
        np.stack([ws, zeros], axis=1),
        np.stack([ws, hs], axis=1),
        np.stack([zeros, hs], axis=1),
    ], axis=1)

    rot = np.zeros((n, 3, 3), dtype=np.float64)
    rot[:, 0, 0] = cos
    rot[:, 0, 1] = -sin
    rot[:, 0, 2] = c - cos * c + sin * c
    rot[:, 1, 0] = sin
    rot[:, 1, 1] = cos
    rot[:, 1, 2] = c - sin * c - cos * c
    rot[:, 2, 2] = 1.0
    xy = np.einsum('nij,nkj->nki', rot[:, :2, :2], corners) \
        + rot[:, None, :2, 2]
    shift = xy.min(axis=1)                                  # (R, 2)
    span = xy.max(axis=1) - shift                           # (R, 2) xy
    mats = rot
    mats[:, :2, 2] -= shift
    mats[:, :2] *= scales_np[:, None, None]
    extents = (
        np.ceil(span[:, ::-1] * scales_np[:, None] - 1e-6).astype(np.int64)
        + 1
    )
    extents = np.minimum(extents, dst_tile)
    return mats, extents


def region_flatten_point_map(mats: np.ndarray, groups, points_xy):
    """Forward-map per-region point sets through the flatten mats.

    ``groups``: (P,) int region index per point; ``points_xy``: (P, 2)
    float xy in each point's region-tile coordinates.  Returns (P, 2)
    float64 xy in the region's dst-tile frame — the analytic co-transform
    of the flattened char polygons (one einsum, no per-region loop)."""
    xy = np.asarray(points_xy, dtype=np.float64).reshape(-1, 2)
    m = np.asarray(mats, dtype=np.float64)[np.asarray(groups, dtype=np.int64)]
    homo = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    out = np.einsum('pij,pj->pi', m, homo)
    return out[:, :2] / out[:, 2:3]


def batch_flatten_regions(
    patches,
    angles_deg: Sequence[float],
    scales: Sequence[float],
    dst_tile: int,
    border_value: float = 0.0,
    content_extents: Optional[np.ndarray] = None,
    return_mats: bool = False,
):
    """Rotate+scale every (src_tile, src_tile, C) region patch through the
    two-shear warp -> (R, dst_tile, dst_tile, C) float32 on the patches'
    device.

    ``patches``: (R, src_tile, src_tile, C) tensor.  Returns (warped,
    extents (R, 2) (h, w)): content occupies [:eh, :ew] of each dst tile.
    With ``return_mats`` also the (R, 3, 3) forward mats (for the analytic
    char-polygon co-transform, region_flatten_point_map)."""
    from .warp_mxu import (
        apply_affine_warp,
        apply_affine_warp_quad,
        plan_affine_warp,
        quadrant_reduce_mats,
    )

    src_tile = int(patches.shape[1])
    assert patches.shape[2] == src_tile, 'square source tiles required'
    mats, extents = plan_region_flatten(
        angles_deg, scales, src_tile, dst_tile,
        content_extents=content_extents,
    )
    quads, reduced = quadrant_reduce_mats(mats, (src_tile, src_tile))
    plan, statics = plan_affine_warp(
        reduced, (src_tile, src_tile), (dst_tile, dst_tile), canonical=True
    )
    plan = convert.affine_warp_plan(plan, patches.device)
    if (quads == 0).all():
        warped = apply_affine_warp(patches, plan, statics,
                                   border_value=border_value)
    else:
        warped = apply_affine_warp_quad(
            patches, quads, plan, statics, border_value=border_value,
        )
    if return_mats:
        return warped, extents, mats
    return warped, extents


# ---------------------------------------------------------------------------
# Char heatmap tiles: analytic gaussian bump through per-char inverse
# homographies.
# ---------------------------------------------------------------------------


def plan_char_heatmap_mats(
    quads_xy: np.ndarray,
    char_radius: int = 25,
) -> np.ndarray:
    """Inverse homographies mapping tile coords -> bump coords.

    ``quads_xy``: (G, 4, 2) float, each char's polygon corners RELATIVE
    to its own tile origin (the char bbox corner), ordered like
    Box.to_polygon.  The bump square spans [0, 2*radius]."""
    from .warp import solve_perspective_batch

    edge = 2 * char_radius
    bump_quad = np.asarray(
        [(0, 0), (edge, 0), (edge, edge), (0, edge)], dtype=np.float64
    )
    g = len(quads_xy)
    mats = solve_perspective_batch(
        np.broadcast_to(bump_quad, (g, 4, 2)),
        np.asarray(quads_xy, dtype=np.float64),
    )
    return np.linalg.inv(mats)


def char_heatmap_tiles(
    mats_inv,
    tile: Optional[int] = None,
    char_radius: int = 25,
    distance_factor: float = 2.25,
):
    """(G, T, T) gaussian bump tiles, evaluated analytically.

    Per pixel: uv = H_inv @ (x, y, 1); r = ||uv - radius|| / radius;
    value = exp(-0.5 * (factor * r)^2), zero outside the bump square.
    ``mats_inv``: (G, 3, 3) float32 tensor; the tiles are made on its
    device.  The 3-term products are written out (the same float32
    operations on the CPU and on a card) and divisions take 0-dim tensors,
    so a card does not turn them into multiplications by a reciprocal."""
    mats_inv = mats_inv.to(torch.float32)
    device = mats_inv.device
    t = tile if tile is not None else 64
    xs = torch.arange(t, dtype=torch.float32, device=device)[None, None, :]
    ys = torch.arange(t, dtype=torch.float32, device=device)[None, :, None]
    radius = torch.tensor(float(char_radius), dtype=torch.float32,
                          device=device)
    edge = 2.0 * float(char_radius)
    out = torch.empty((len(mats_inv), t, t), dtype=torch.float32,
                      device=device)
    for g0 in range(0, len(mats_inv), _HEATMAP_CHUNK):
        m = mats_inv[g0:g0 + _HEATMAP_CHUNK, :, :, None, None]

        def row(i):
            return m[:, i, 0] * xs + m[:, i, 1] * ys + m[:, i, 2]

        w = row(2)
        w = torch.where(w.abs() < 1e-9, 1e-9, w)
        u = row(0) / w
        v = row(1) / w
        r = torch.sqrt((u - radius) ** 2 + (v - radius) ** 2) / radius
        value = torch.exp(-0.5 * (distance_factor * r) ** 2)
        inside = (u >= 0) & (u <= edge) & (v >= 0) & (v <= edge)
        out[g0:g0 + _HEATMAP_CHUNK] = torch.where(inside, value, 0.0)
    return out


def batch_char_heatmaps(
    quads_xy: np.ndarray,
    tile: int = 64,
    char_radius: int = 25,
    distance_factor: float = 2.25,
    device='cuda',
):
    """Host-plan + device-evaluate all char bump tiles: (G, tile, tile)
    float32 on ``device``, one tile per quad (the reference pads the tile
    count to a power of two for its compiled signature; its callers index
    only the real rows)."""
    mats_inv = plan_char_heatmap_mats(quads_xy, char_radius)
    return char_heatmap_tiles(
        convert.to_tensor(mats_inv, convert.resolve_device(device),
                          torch.float32),
        tile=tile, char_radius=char_radius,
        distance_factor=distance_factor,
    )


# ---------------------------------------------------------------------------
# Region window gather: device slices of the warped page batch.
# ---------------------------------------------------------------------------


def _inside_polygons(quads, tile: int):
    """Crossing-number test of every tile pixel against each row's polygon:
    (R, 4, 2) float32 corners -> (R, tile, tile) float32 in {0, 1}."""
    device = quads.device
    y = torch.arange(tile, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(tile, dtype=torch.float32, device=device)[None, None, :]
    hits = torch.zeros((len(quads), tile, tile), dtype=torch.int32,
                       device=device)
    for k in range(4):
        x0 = quads[:, k, 0][:, None, None]
        y0 = quads[:, k, 1][:, None, None]
        x1 = quads[:, (k + 1) % 4, 0][:, None, None]
        y1 = quads[:, (k + 1) % 4, 1][:, None, None]
        crossing = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
        dy = torch.where((y1 - y0).abs() < 1e-12, 1e-12, y1 - y0)
        cx = x0 + (y - y0) / dy * (x1 - x0)
        hits += (crossing & (x < cx)).to(torch.int32)
    return (hits % 2 == 1).to(torch.float32)


def gather_region_windows(
    images,
    active,
    sids,
    ups,
    lefts,
    heights,
    widths,
    quads_xy,
    tile: int,
):
    """Every region's source patch, built on the pages' device.

    Per region: the (tile, tile) window at (up, left) of page ``sid`` (one
    indexed gather over the pages padded by a tile, so edge windows never
    shift), the rgb gated to the window extent, and the alpha as the page
    active raster intersected with the region's dilated word polygon
    (crossing-number test in window-relative coords).

    ``images``: (N, H, W, 3) and ``active``: (N, H, W) tensors; the row
    fields are host arrays; ``quads_xy``: (R, 4, 2) polygon corners relative
    to each window's origin.  Returns (R, tile, tile, 4) float32 (rgb +
    alpha)."""
    device = images.device
    n, height, width = active.shape
    imgs = torch.zeros((n, height + tile, width + tile, images.shape[3]),
                       dtype=torch.float32, device=device)
    imgs[:, :height, :width] = images
    act = torch.zeros((n, height + tile, width + tile), dtype=torch.float32,
                      device=device)
    act[:, :height, :width] = active

    def rows_of(values, high):
        # lax.dynamic_slice clamps a start so that the window fits.
        t = convert.to_tensor(np.asarray(values, np.int64), device)
        return t.clamp(0, high)

    span = torch.arange(tile, device=device)
    sid = rows_of(sids, n - 1)[:, None, None]
    ys = (rows_of(ups, height)[:, None] + span)[:, :, None]
    xs = (rows_of(lefts, width)[:, None] + span)[:, None, :]
    img = imgs[sid, ys, xs]                                  # (R, T, T, C)
    a = act[sid, ys, xs]                                     # (R, T, T)

    h = convert.to_tensor(np.asarray(heights, np.float32), device)
    w = convert.to_tensor(np.asarray(widths, np.float32), device)
    grid = span.to(torch.float32)
    in_extent = ((grid[None, :, None] < h[:, None, None])
                 & (grid[None, None, :] < w[:, None, None])
                 ).to(torch.float32)
    quads = convert.to_tensor(np.asarray(quads_xy, np.float32), device)
    alpha = a * _inside_polygons(quads, tile) * in_extent
    rgb = img * in_extent[..., None]
    return torch.cat([rgb, alpha[..., None]], dim=-1)
