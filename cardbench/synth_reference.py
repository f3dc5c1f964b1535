"""The plain reference of the synth cells' check: PyTorch on the device it
is given, in float64 (or, for the control, bfloat16), with no import of
the program.

Unlike the distort cells' reference, this one reads each page's warp from
the page's own plan (its forward matrix, or its source and destination
lattices) rather than re-deriving it from a policy's config: the check
guards the device path (assembly, routes, kernels, crops, the region
flatten), and the host planner is held to vkit_tpu's by the repo's tests
and by the distort cells' config-derived check.  The photometric stage
and finish are not checked.

- ``assemble_pages``, ``assemble_mismatches``: the page assembly by its
  own definition, each prepared page's glyphs and then its above-text
  patches blended onto its background in order, each glyph tile
  resampled to its box with bilinear taps at half-pixel centers, the
  page rounded to uint8 after each of the two layers; the share of the
  pixels that differ from it;
- ``page_geometry``: a plan's warp as ``policies.common.Geometry``, which
  ``reference.warp_gaps`` and ``reference.geometry_points`` read (the
  exact bilinear remap of the warp's input, the points' forward map);
- ``crop_mismatches``: pixels of each crop that differ from the page's
  slice at the crop's window;
- ``flatten_mat``, ``flatten_gap``: the region flatten by its own
  definition, a rotation about the source tile's center, the rotated
  content's corner moved to the origin and a scale, resampled by the two
  shear passes of that matrix (after the quarter turn that conditions
  them best) with linear interpolation in each pass.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cardbench.policies.common import Geometry
from cardbench.reference import PLANE_SCALE

# Pixels of a flattened region whose source position lies this far inside
# the source tile are compared (the border rule of the passes is left out).
FLATTEN_MARGIN = 2


def page_geometry(plan) -> Geometry:
    """The warp of a page's plan: its forward matrix (the identity for a
    plan that does nothing), or its lattices."""
    if plan.dst_lattice is not None:
        return Geometry(tuple(plan.dst_shape),
                        src_lattice=np.asarray(plan.src_lattice, np.float64),
                        dst_lattice=np.asarray(plan.dst_lattice, np.float64),
                        grid_size=int(plan.grid_size))
    matrix = np.eye(3) if plan.matrix is None else np.asarray(plan.matrix,
                                                              np.float64)
    return Geometry(tuple(plan.dst_shape), matrix=matrix)


def crop_mismatches(pages: Sequence[torch.Tensor],
                    crops: Sequence[torch.Tensor], page_ids, windows,
                    size: int) -> int:
    """Pixels (any channel) where a crop differs from its page's slice at
    its window (up, left); ``pages`` and ``crops`` pair tensors of one
    kind (images, labels, masks) as (N, H, W[, C]) and (M, S, S[, C])."""
    wrong = 0
    for page, crop in zip(pages, crops):
        for i, (sid, (up, left)) in enumerate(zip(page_ids, windows)):
            want = page[int(sid), int(up):int(up) + size,
                        int(left):int(left) + size]
            got = crop[i]
            if want.shape != got.shape:
                wrong += int(got[..., 0].numel() if got.dim() == 3
                             else got.numel())
                continue
            differ = want != got
            if differ.dim() == 3:
                differ = differ.any(dim=-1)
            wrong += int(differ.sum())
    return wrong


def flatten_mat(angle_deg: float, scale: float, src_tile: int,
                extent) -> np.ndarray:
    """The forward 3x3 matrix that flattens a region: rotate the source
    tile by ``angle_deg`` about its center, move the rotated content
    rectangle (``extent`` (h, w) at the tile's top-left) to the origin,
    scale by ``scale``."""
    c = (src_tile - 1) / 2.0
    t = np.deg2rad(float(angle_deg))
    cos, sin = np.cos(t), np.sin(t)
    rot = np.asarray([[cos, -sin, c - cos * c + sin * c],
                      [sin, cos, c - sin * c - cos * c],
                      [0.0, 0.0, 1.0]])
    h, w = float(extent[0]) - 1.0, float(extent[1]) - 1.0
    corners = np.asarray([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]],
                         np.float64)
    moved = corners @ rot.T
    rot[:2, 2] -= moved[:, :2].min(axis=0)
    rot[:2] *= float(scale)
    return rot


def _quarter_turn(matrix: np.ndarray, side: int):
    """(k, matrix of the k-times quarter-turned source): the k in 0-3
    whose inverse's [0, 0] is the largest share of its row's first two
    entries (the first such k on ties), as the two shear passes need."""
    s = float(side - 1)
    turns = [np.eye(3),
             np.asarray([[0, -1, s], [1, 0, 0], [0, 0, 1]], np.float64),
             np.asarray([[-1, 0, s], [0, -1, s], [0, 0, 1]], np.float64),
             np.asarray([[0, 1, 0], [-1, 0, s], [0, 0, 1]], np.float64)]
    best, best_k = -2.0, 0
    for k, turn in enumerate(turns):
        inv = np.linalg.inv(matrix @ turn)
        score = inv[0, 0] / max(np.sqrt(inv[0, 0] ** 2 + inv[0, 1] ** 2),
                                1e-12)
        if score > best:
            best, best_k = score, k
    return best_k, matrix @ turns[best_k]


def _lerp(lines, pos, dtype):
    """Linear samples of each line of ``lines`` (L, len, C) at positions
    ``pos`` (L, J) in ``dtype``; beyond the line the border is 0."""
    length = lines.shape[1]
    lo = torch.floor(pos.to(torch.float64)).to(torch.int64)
    frac = (pos - lo.to(dtype))[..., None]

    def take(index):
        inside = ((index >= 0) & (index < length))[..., None]
        got = torch.gather(
            lines, 1, index.clamp(0, length - 1)[..., None].expand(
                -1, -1, lines.shape[2]))
        return torch.where(inside, got, torch.zeros((), dtype=dtype,
                                                    device=got.device))

    return take(lo) * (1 - frac) + take(lo + 1) * frac


def flatten_two_pass(patch, matrix: np.ndarray, dst_tile: int,
                     dtype=torch.float64):
    """(dst_tile, dst_tile, C) of ``patch`` (T, T, C) warped by the forward
    ``matrix`` through its two shear passes, in ``dtype``: after the
    quarter turn, pass one resamples each source column at
    ``beta * y + alpha * u + gamma``, pass two each of its rows at
    ``a * x + b * y + c`` (a, b, c, d, e, f the inverse's first two
    rows; alpha = d / a, beta = e - d b / a, gamma = f - d c / a)."""
    side = patch.shape[0]
    k, turned = _quarter_turn(matrix, side)
    src = torch.rot90(patch, k, dims=(0, 1)).to(dtype)
    inv = np.linalg.inv(turned)
    a, b, c = inv[0]
    d, e, f = inv[1, :3]
    alpha, beta, gamma = d / a, e - d * b / a, f - d * c / a
    device = patch.device
    y = torch.arange(dst_tile, device=device, dtype=torch.float64)
    u = torch.arange(side, device=device, dtype=torch.float64)
    pos_v = (beta * y[None, :] + alpha * u[:, None] + gamma).to(dtype)
    columns = src.permute(1, 0, 2)                    # (u, rows, C)
    tmp = _lerp(columns, pos_v, dtype).permute(1, 0, 2)  # (y, u, C)
    x = torch.arange(dst_tile, device=device, dtype=torch.float64)
    pos_h = (a * x[None, :] + b * y[:, None] + c).to(dtype)
    return _lerp(tmp, pos_h, dtype)


def flatten_gap(patch, out, angle_deg: float, scale: float, extent,
                out_extent, device, control: bool = False
                ) -> Optional[float]:
    """The largest, over channels, mean |out - reference| of one flattened
    region (channel 3, the 0-1 mask, scaled to LSB) over the pixels of its
    output extent whose exact source position lies FLATTEN_MARGIN inside
    the source tile.  With ``control`` the reference computed in bfloat16
    takes the program's place.  None where no pixel is compared."""
    side = patch.shape[0]
    dst_tile = out.shape[0]
    matrix = flatten_mat(angle_deg, scale, side, extent)
    patch = patch.to(device)
    ref = flatten_two_pass(patch, matrix, dst_tile)
    got = (flatten_two_pass(patch, matrix, dst_tile, torch.bfloat16)
           if control else out.to(device)).to(torch.float64)
    inv = torch.as_tensor(np.linalg.inv(matrix), device=device)
    gy, gx = torch.meshgrid(
        torch.arange(dst_tile, device=device, dtype=torch.float64),
        torch.arange(dst_tile, device=device, dtype=torch.float64),
        indexing='ij')
    sx = inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]
    sy = inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]
    lo, hi = FLATTEN_MARGIN, side - 1 - FLATTEN_MARGIN
    region = ((sx >= lo) & (sx <= hi) & (sy >= lo) & (sy <= hi)
              & (gy < int(out_extent[0])) & (gx < int(out_extent[1])))
    if not bool(region.any()):
        return None
    gap = (got[region] - ref[region]).abs().mean(dim=0)
    scales = torch.ones(gap.shape[0], dtype=torch.float64, device=device)
    if gap.shape[0] > 3:
        scales[3] = PLANE_SCALE
    return float((gap * scales).max())


def _bilinear_weights(out_len: int, src, dst, taps: int, dtype):
    """(G, out_len, taps) linear weights: output pixel i of a box ``dst``
    long reads source coordinate (i + 0.5) * src / dst - 0.5 of a line
    ``src`` long; taps outside [0, taps) and pixels past the box read 0."""
    i = torch.arange(out_len, dtype=torch.float64)
    src = torch.as_tensor(np.asarray(src, np.float64))
    dst = torch.as_tensor(np.asarray(dst, np.float64))
    pos = (i[None] + 0.5) * (src / dst.clamp(min=1))[:, None] - 0.5
    lo = torch.floor(pos)
    frac = (pos - lo)[..., None]
    lo = lo.to(torch.int64)[..., None]
    k = torch.arange(taps)
    w = (k == lo) * (1 - frac) + (k == lo + 1) * frac
    return (w * (i[None, :, None] < dst[:, None, None])).to(dtype)


def _blend(canvas, alpha, paint, up: int, left: int):
    """canvas[box] = alpha * paint + (1 - alpha) * canvas[box] for the
    part of the (h, w) box at (up, left) that lies on the canvas."""
    height, width = canvas.shape[:2]
    h, w = alpha.shape
    y0, x0 = max(up, 0), max(left, 0)
    y1, x1 = min(up + h, height), min(left + w, width)
    if y0 >= y1 or x0 >= x1:
        return
    a = alpha[y0 - up:y1 - up, x0 - left:x1 - left, None]
    if paint.dim() == 3:
        paint = paint[y0 - up:y1 - up, x0 - left:x1 - left]
    canvas[y0:y1, x0:x1] = a * paint + (1 - a) * canvas[y0:y1, x0:x1]


def _to_uint8(canvas):
    return torch.round(canvas.to(torch.float64)).clamp(0, 255).to(
        torch.uint8)


def _glyphs(page, dtype):
    """Every glyph of a page in order: (alphas (G, S, S) resampled to
    their boxes and clipped to [0, 1], colors (G, 3), ups, lefts,
    heights, widths)."""
    tiles, rows = [], []
    for layout, (up, left), color, atlas in page.line_entries:
        atlas_tiles = atlas.snapshot()[2]
        for box, gid, src_h, src_w in zip(
                layout.char_boxes, layout.glyph_ids, layout.src_hs,
                layout.src_ws):
            tiles.append(atlas_tiles[int(gid)])
            rows.append((up + box.up, left + box.left, box.height,
                         box.width, float(src_h), float(src_w)) + tuple(
                             float(c) for c in color))
    if not rows:
        return None
    taps = max(t.shape[0] for t in tiles)
    stack = np.zeros((len(tiles), taps, taps), np.float64)
    for g, tile in enumerate(tiles):
        stack[g, :tile.shape[0], :tile.shape[1]] = tile
    rows = np.asarray(rows, np.float64)
    side = int(rows[:, 2:4].max())
    w_y = _bilinear_weights(side, rows[:, 4], rows[:, 2], taps, dtype)
    w_x = _bilinear_weights(side, rows[:, 5], rows[:, 3], taps, dtype)
    alphas = (w_y @ torch.from_numpy(stack).to(dtype)
              @ w_x.transpose(1, 2)).clamp(0, 1)
    return (alphas, torch.from_numpy(rows[:, 6:9]).to(dtype),
            rows[:, :4].astype(np.int64))


def assemble_pages(pages, dtype=torch.float64) -> torch.Tensor:
    """(N, H, W, 3) uint8: each prepared page (the program's ``HostPage``:
    ``background``, ``line_entries`` of (layout, (up, left), color,
    atlas), ``overlay_entries``) assembled in ``dtype`` on the CPU.  A
    glyph's tile is its atlas's tile; its box is the layout's char box
    moved to the line's anchor, resampled from the glyph's ink extent."""
    out = []
    for page in pages:
        canvas = torch.tensor(np.asarray(page.background)).to(dtype)
        glyphs = _glyphs(page, dtype)
        if glyphs is not None:
            alphas, colors, boxes = glyphs
            for g, (up, left, h, w) in enumerate(boxes):
                _blend(canvas, alphas[g, :h, :w], colors[g], int(up),
                       int(left))
        canvas = _to_uint8(canvas).to(dtype)
        for entry in page.overlay_entries:
            alpha = torch.tensor(np.asarray(entry.alpha, np.float64)
                                 ).to(dtype).clamp(0, 1)
            paint = torch.tensor(np.asarray(
                entry.color if entry.rgb is None else entry.rgb,
                np.float64)).to(dtype)
            _blend(canvas, alpha, paint, entry.up, entry.left)
        out.append(_to_uint8(canvas))
    return torch.stack(out)


def assemble_mismatches(got, want) -> Tuple[float, int]:
    """(percent of the pixels where any channel of ``got`` differs from
    ``want``, the largest difference in LSB), for two uint8 page
    batches."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    differ = (diff > 0).any(dim=-1)
    return 100.0 * float(differ.sum()) / differ.numel(), int(diff.max())
