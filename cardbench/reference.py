"""The plain reference that decides ``correct``: PyTorch on whatever
device it is given, in float64 (or, for the control, bfloat16), with no
import of the program.

It works out every output pixel of a warp from the warp's input and the
sample's geometry (``policies/<policy>.py``), which the reference derives
from the config the frozen sampler drew, not from the program's plans:
each output pixel's source position by the inverse of the geometry's
matrix, or of each lattice cell's homography between its rounded source
rectangle and its rounded projected quad, then a bilinear sample of the
warp's input there; and each label point's place through the same
geometry.
"""
from typing import List, Optional, Tuple

import numpy as np
import torch

# Erosion of the compared region: pixels this far inside the covered
# region only.  A lattice plan's banded route interpolates its coarse node
# field linearly up to one node cell (16 px) from the coverage edge, where
# it differs from the exact map by up to ~142 LSB (PARITY.md).
LATTICE_MARGIN = 16
AFFINE_MARGIN = 2
# Scale that turns a 0-1 label plane into LSB of an 8-bit image.
PLANE_SCALE = 255.0


def _bilinear(src, ys, xs, dtype):
    """Bilinear samples of ``src`` (H, W, C) at positions (M,) rounded to
    ``dtype``, computed in ``dtype``; the positions must lie inside
    [0, H - 1] x [0, W - 1] (the neighbours' indices clamp into it)."""
    h, w = src.shape[:2]
    src = src.to(dtype)
    ys = ys.to(dtype)
    xs = xs.to(dtype)
    y0 = torch.floor(ys.to(torch.float64)).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(xs.to(torch.float64)).to(torch.int64).clamp(0, w - 1)
    fy = (ys - y0.to(dtype))[:, None]
    fx = (xs - x0.to(dtype))[:, None]
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    top = src[y0, x0] * (1 - fx) + src[y0, x1] * fx
    bottom = src[y1, x0] * (1 - fx) + src[y1, x1] * fx
    return top * (1 - fy) + bottom * fy


def _erode(mask, margin: int):
    """Pixels of the (H, W) bool ``mask`` whose (2 margin + 1)-square
    neighbourhood lies wholly inside it."""
    if margin <= 0:
        return mask
    outside = (~mask).to(torch.float32)[None, None]
    grown = torch.nn.functional.max_pool2d(
        outside, 2 * margin + 1, stride=1, padding=margin)
    return (grown[0, 0] == 0) & mask


def matrix_backward(matrix, dst_shape, device, dtype=torch.float64):
    """(map_y, map_x) of a forward 2x3 or 3x3 matrix on the dst canvas."""
    full = np.eye(3, dtype=np.float64)
    m = np.asarray(matrix, dtype=np.float64)
    full[:m.shape[0]] = m
    inv = torch.as_tensor(np.linalg.inv(full), device=device).to(dtype)
    h, w = dst_shape
    gy, gx = torch.meshgrid(
        torch.arange(h, device=device, dtype=torch.float64).to(dtype),
        torch.arange(w, device=device, dtype=torch.float64).to(dtype),
        indexing='ij')
    sx = inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]
    sy = inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]
    wz = inv[2, 0] * gx + inv[2, 1] * gy + inv[2, 2]
    return sy / wz, sx / wz


def _normalizer(pts):
    """(K, 3, 3) similarity moving each quad's centroid to the origin and
    its mean distance from it to sqrt(2) (Hartley's conditioning)."""
    center = pts.mean(dim=1)
    dist = (pts - center[:, None]).norm(dim=-1).mean(dim=1)
    scale = np.sqrt(2.0) / torch.clamp(dist, min=1e-12)
    t = torch.zeros((pts.shape[0], 3, 3), dtype=pts.dtype, device=pts.device)
    t[:, 0, 0] = scale
    t[:, 1, 1] = scale
    t[:, :2, 2] = -center * scale[:, None]
    t[:, 2, 2] = 1.0
    return t


def _homographies(src_pts, dst_pts):
    """(K, 3, 3) float64 maps carrying each of K quads ``src_pts`` (K, 4, 2)
    onto ``dst_pts``, and a (K,) bool of the solvable ones."""
    k = src_pts.shape[0]
    t_src, t_dst = _normalizer(src_pts), _normalizer(dst_pts)

    def apply(t, p):
        return p * t[:, None, 0, 0, None] + t[:, None, :2, 2]

    s_n, d_n = apply(t_src, src_pts), apply(t_dst, dst_pts)
    x, y = s_n[..., 0], s_n[..., 1]
    u, v = d_n[..., 0], d_n[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.cat([rows_u, rows_v], dim=1)              # (K, 8, 8)
    b = torch.cat([u, v], dim=1)                        # (K, 8)
    sol, info = torch.linalg.solve_ex(a, b)
    ok = (info == 0) & torch.isfinite(sol).all(dim=1)
    h = torch.cat([torch.where(ok[:, None], sol, 0.0),
                   torch.ones((k, 1), dtype=sol.dtype, device=sol.device)],
                  dim=1).reshape(k, 3, 3)
    return torch.linalg.inv(t_dst) @ h @ t_src, ok


def lattice_backward(src_lattice, dst_lattice, dst_shape, device,
                     dtype=torch.float64, chunk_pixels: int = 1 << 22):
    """(map_y, map_x, covered) of a lattice plan: each dst pixel inside a
    cell's rounded projected quad takes the cell's dst -> src homography.
    A pixel belongs to the cell whose source rectangle its mapped position
    falls in."""
    src = np.round(np.asarray(src_lattice, np.float64))
    dst = np.round(np.asarray(dst_lattice, np.float64))

    def quads(p):
        return np.stack([p[:-1, :-1], p[:-1, 1:], p[1:, 1:], p[1:, :-1]],
                        axis=2).reshape(-1, 4, 2)

    sq = torch.as_tensor(quads(src), device=device)
    dq = torch.as_tensor(quads(dst), device=device)
    inv, ok = _homographies(dq, sq)
    h, w = dst_shape
    map_y = torch.zeros((h, w), dtype=dtype, device=device)
    map_x = torch.zeros((h, w), dtype=dtype, device=device)
    covered = torch.zeros((h, w), dtype=torch.bool, device=device)
    lo = torch.floor(dq.min(dim=1).values).to(torch.int64)   # (K, 2) xy
    hi = torch.ceil(dq.max(dim=1).values).to(torch.int64)
    size = int((hi - lo + 1).max())
    cells = int(ok.sum())
    idx_ok = torch.nonzero(ok).flatten()
    step = max(1, chunk_pixels // (size * size))
    off = torch.arange(size, device=device)
    s_lo = sq.min(dim=1).values
    s_hi = sq.max(dim=1).values
    inv_d = inv.to(dtype)
    for c0 in range(0, cells, step):
        sel = idx_ok[c0:c0 + step]
        px = lo[sel, 0][:, None, None] + off[None, None, :]
        py = lo[sel, 1][:, None, None] + off[None, :, None]
        px = px.expand(-1, size, size)
        py = py.expand(-1, size, size)
        m = inv_d[sel]
        fx, fy = px.to(dtype), py.to(dtype)
        wz = m[:, 2, 0, None, None] * fx + m[:, 2, 1, None, None] * fy \
            + m[:, 2, 2, None, None]
        sx = (m[:, 0, 0, None, None] * fx + m[:, 0, 1, None, None] * fy
              + m[:, 0, 2, None, None]) / wz
        sy = (m[:, 1, 0, None, None] * fx + m[:, 1, 1, None, None] * fy
              + m[:, 1, 2, None, None]) / wz
        eps = 1e-6
        inside = ((px <= hi[sel, 0][:, None, None])
                  & (py <= hi[sel, 1][:, None, None])
                  & (px >= 0) & (px < w) & (py >= 0) & (py < h)
                  & (sx >= s_lo[sel, 0][:, None, None].to(dtype) - eps)
                  & (sx <= s_hi[sel, 0][:, None, None].to(dtype) + eps)
                  & (sy >= s_lo[sel, 1][:, None, None].to(dtype) - eps)
                  & (sy <= s_hi[sel, 1][:, None, None].to(dtype) + eps))
        ys, xs = py[inside], px[inside]
        map_y[ys, xs] = sy[inside]
        map_x[ys, xs] = sx[inside]
        covered[ys, xs] = True
    return map_y, map_x, covered


def geometry_backward(geom, device, dtype=torch.float64):
    """(map_y, map_x, covered, margin) of a sample's Geometry."""
    if geom.matrix is not None:
        map_y, map_x = matrix_backward(geom.matrix, geom.dst_shape, device,
                                       dtype)
        covered = torch.ones(geom.dst_shape, dtype=torch.bool, device=device)
        return map_y, map_x, covered, AFFINE_MARGIN
    map_y, map_x, covered = lattice_backward(
        geom.src_lattice, geom.dst_lattice, geom.dst_shape, device, dtype)
    return map_y, map_x, covered, LATTICE_MARGIN


def _channel_scales(channels: int, planes: Tuple[int, ...]):
    scales = torch.ones(channels, dtype=torch.float64)
    for c in planes:
        scales[c] = PLANE_SCALE
    return scales


def geometry_points(geom, points_xy, device, dtype=torch.float64
                    ) -> np.ndarray:
    """(P, 2) xy of ``points_xy`` mapped forward through a sample's
    Geometry: its matrix, or the homography of the lattice cell each point
    falls in (the cell of the rounded point, the last one beyond the
    lattice) from the rounded source rectangle onto the rounded quad."""
    xy = torch.as_tensor(np.asarray(points_xy, np.float64), device=device)
    homo = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=1)
    if geom.matrix is not None:
        full = np.eye(3, dtype=np.float64)
        m = np.asarray(geom.matrix, dtype=np.float64)
        full[:m.shape[0]] = m
        mats = torch.as_tensor(full, device=device)[None].expand(
            len(xy), 3, 3)
    else:
        src = np.round(np.asarray(geom.src_lattice, np.float64))
        dst = np.round(np.asarray(geom.dst_lattice, np.float64))
        rows, cols = src.shape[0] - 1, src.shape[1] - 1
        grid = geom.grid_size
        pts = np.asarray(points_xy, np.float64)
        r = np.minimum(np.round(pts[:, 1]).astype(np.int64) // grid,
                       rows - 1)
        c = np.minimum(np.round(pts[:, 0]).astype(np.int64) // grid,
                       cols - 1)

        def corners(p):
            return np.stack([p[r, c], p[r, c + 1], p[r + 1, c + 1],
                             p[r + 1, c]], axis=1)

        mats, _ = _homographies(torch.as_tensor(corners(src), device=device),
                                torch.as_tensor(corners(dst), device=device))
    out = torch.einsum('pij,pj->pi', mats.to(dtype), homo.to(dtype))
    return (out[:, :2] / out[:, 2:3]).to(torch.float64).cpu().numpy()


def remap_gap(src, out, maps, covered, margin: int, scales,
              control_maps=None) -> Optional[float]:
    """The largest, over channels, mean |out - reference| (channels scaled
    by ``scales``) over the compared region: covered pixels whose source
    position (``maps``, float64) lies one pixel inside the source, eroded
    by ``margin``.  ``src`` (H, W, C) and ``out`` (Ho, Wo, C) are on the
    reference's device.  With ``control_maps`` (bfloat16) the reference
    computed in bfloat16 takes the program's place.  An output smaller
    than the reference's canvas reads 0 where it has no pixels.  None
    where the region is empty."""
    map_y, map_x = maps
    h, w = src.shape[:2]
    ho, wo = map_y.shape
    out = torch.nn.functional.pad(
        out, (0, 0, 0, max(0, wo - out.shape[1]), 0,
              max(0, ho - out.shape[0])))
    inside = covered & (map_y >= 1) & (map_y <= h - 2) \
        & (map_x >= 1) & (map_x <= w - 2)
    region = _erode(inside, margin)
    if not bool(region.any()):
        return None
    ref = _bilinear(src, map_y[region], map_x[region], torch.float64)
    if control_maps is None:
        got = out[:ho, :wo][region].to(torch.float64)
    else:
        got = _bilinear(src, control_maps[0][region],
                        control_maps[1][region], torch.bfloat16)
    gap = (got.to(torch.float64) - ref).abs().mean(dim=0)
    return float((gap * scales.to(gap.device)).max())


def warp_gaps(geoms, src, out, device, planes=(), control: bool = False
              ) -> List[Optional[float]]:
    """remap_gap of every sample of one batched warp: ``geoms`` the
    samples' Geometry, ``src`` (N, H, W, C) and ``out`` (N, Ho, Wo, C) host
    tensors, ``planes`` the channels that hold 0-1 label planes."""
    scales = _channel_scales(src.shape[-1], tuple(planes))
    gaps = []
    for i, geom in enumerate(geoms):
        map_y, map_x, covered, margin = geometry_backward(geom, device)
        ctl = None
        if control:
            ctl = geometry_backward(geom, device, torch.bfloat16)[:2]
        gaps.append(remap_gap(
            src[i].to(device), out[i].to(device), (map_y, map_x), covered,
            margin, scales, ctl))
    return gaps
