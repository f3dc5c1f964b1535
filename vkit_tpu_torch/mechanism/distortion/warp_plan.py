"""WarpPlan: the single canonical form of every geometric distortion.

An affine/perspective op contributes an analytic forward matrix; a
lattice-projected op (camera models, MLS) contributes a projected grid from
which per-cell inverse homographies produce a dense backward map.  One set
of appliers serves rasters (device/native remap kernels) and geometry
(vectorized forward transforms) for the whole catalog.

Behavioral spec: vkit/mechanism/distortion/geometric/grid_rendering/*
(re-derived; lattices here are (R, C, 2) float64 xy arrays, not point
objects, and all per-cell solves are batched).
"""
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ... import geometry
from ...element import Image, Mask, Polygon, ScoreMap
from ...ops import warp as warp_ops


_BWD_NATIVE = None
_BWD_NATIVE_TRIED = False


def _native_lattice_backward_maps(dst_quads, inv_mats, shape):
    """C++ per-cell fill + homography (vkit_tpu/native); None if
    unavailable.  Bit-compatible with the Python per-cell loop below
    (same vg_fill_poly coverage rule)."""
    global _BWD_NATIVE, _BWD_NATIVE_TRIED
    if not _BWD_NATIVE_TRIED:
        _BWD_NATIVE_TRIED = True
        try:
            from ...native import load_library
            lib = load_library()
            if lib is not None and hasattr(lib, 'vg_lattice_backward_maps'):
                _BWD_NATIVE = lib
        except Exception:  # noqa: BLE001
            _BWD_NATIVE = None
    if _BWD_NATIVE is None:
        return None

    import ctypes
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    dst_h, dst_w = shape
    quads = np.ascontiguousarray(dst_quads, dtype=np.float64)
    mats = np.ascontiguousarray(inv_mats, dtype=np.float64)
    map_y = np.zeros((dst_h, dst_w), dtype=np.float32)
    map_x = np.zeros((dst_h, dst_w), dtype=np.float32)
    covered = np.zeros((dst_h, dst_w), dtype=np.uint8)
    _BWD_NATIVE.vg_lattice_backward_maps(
        quads.ctypes.data_as(f64p), mats.ctypes.data_as(f64p),
        len(quads), dst_h, dst_w,
        map_y.ctypes.data_as(f32p), map_x.ctypes.data_as(f32p),
        covered.ctypes.data_as(u8p),
    )
    return map_y, map_x, covered.astype(bool)


@dataclass
class WarpPlan:
    src_shape: Tuple[int, int]
    dst_shape: Tuple[int, int]
    # Analytic form: forward 2x3 affine or 3x3 homography.
    matrix: Optional[np.ndarray] = None
    # Lattice form.
    src_lattice: Optional[np.ndarray] = None   # (R, C, 2) float64 xy
    dst_lattice: Optional[np.ndarray] = None
    grid_size: Optional[int] = None
    shift_xy: Tuple[float, float] = (0.0, 0.0)     # pre-resize origin shift
    resize_ratio_xy: Tuple[float, float] = (1.0, 1.0)
    nop: bool = False
    _cache: Dict = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    @property
    def result_shape(self) -> Tuple[int, int]:
        return self.dst_shape

    @property
    def is_lattice(self) -> bool:
        return self.dst_lattice is not None

    def _int_lattice(self, which: str) -> np.ndarray:
        lat = self.src_lattice if which == 'src' else self.dst_lattice
        assert lat is not None
        key = f'int_{which}'
        if key not in self._cache:
            self._cache[key] = np.round(lat).astype(np.int64)
        return self._cache[key]

    def _quads(self, which: str) -> np.ndarray:
        """All cell quads (N, 4, 2), clockwise from up-left, int-rounded."""
        pts = self._int_lattice(which).astype(np.float64)
        quads = np.stack(
            [pts[:-1, :-1], pts[:-1, 1:], pts[1:, 1:], pts[1:, :-1]], axis=2
        )
        return quads.reshape(-1, 4, 2)

    def _cell_mats_native(self, inverse: bool):
        """Native single-pass twin of _cell_mats (closed form + adjugate
        inverse + validation in C, no 6k-cell numpy temps); None when the
        library is unavailable.  Cells the closed form cannot certify
        fall back to the linear solver exactly like the numpy path."""
        try:
            from ...native import load_library
            lib = load_library()
        except Exception:  # noqa: BLE001
            return None
        if lib is None or not hasattr(lib, 'vg_cell_mats'):
            return None
        import ctypes
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        src, dst = self._quads('src'), self._quads('dst')
        n = len(src)
        rects = np.ascontiguousarray(
            np.stack([src[:, 0, 0], src[:, 0, 1],
                      src[:, 2, 0], src[:, 2, 1]], axis=1)
        )
        dstc = np.ascontiguousarray(dst, dtype=np.float64)
        fwd = np.empty((n, 3, 3), dtype=np.float64)
        inv = np.empty((n, 3, 3), dtype=np.float64)
        bad = np.empty(n, dtype=np.uint8)
        lib.vg_cell_mats(
            rects.ctypes.data_as(f64p), dstc.ctypes.data_as(f64p),
            n, fwd.ctypes.data_as(f64p), inv.ctypes.data_as(f64p),
            bad.ctypes.data_as(u8p),
        )
        bad_fwd = (bad & 1).astype(bool)
        if bad_fwd.any():
            fwd[bad_fwd] = warp_ops.solve_perspective_batch(
                src[bad_fwd], dst[bad_fwd]
            )
            # The C pass computed these cells' inverses from the
            # pre-fallback closed form; redo them (numpy-path semantics:
            # det-guarded matrix inverse of the FINAL forward).
            f = fwd[bad_fwd]
            with np.errstate(all='ignore'):
                det = np.linalg.det(f)
                safe = np.isfinite(det) & (np.abs(det) > 1e-12)
                inv_f = np.linalg.inv(
                    np.where(safe[:, None, None], f, np.eye(3)[None])
                )
            inv[bad_fwd] = inv_f
            # Recompute bit1 for these cells from the final forward.
            bad[bad_fwd] &= np.uint8(1)
            still = np.flatnonzero(bad_fwd)[
                ~(safe & np.isfinite(inv_f).all(axis=(1, 2)))
            ]
            bad[still] |= 2
        bad_inv = (bad & 2).astype(bool)
        if bad_inv.any():
            inv[bad_inv] = warp_ops.solve_perspective_batch(
                dst[bad_inv], src[bad_inv]
            )
        self._cache['fwd_mats'] = fwd
        self._cache['inv_mats'] = inv
        return self._cache['inv_mats' if inverse else 'fwd_mats']

    def _cell_mats(self, inverse: bool) -> np.ndarray:
        key = 'inv_mats' if inverse else 'fwd_mats'
        if key not in self._cache:
            native = self._cell_mats_native(inverse)
            if native is not None:
                return native
        if key not in self._cache:
            if 'fwd_mats' not in self._cache:
                # The SOURCE lattice cells are axis-aligned rectangles by
                # construction: the closed-form rect->quad homography
                # replaces ~6k 8x8 linear solves per plan (~15ms -> ~1ms).
                # Degenerate cells (rounding collapses a quad) fall back
                # to the linear solver, which pins their semantics.
                src, dst = self._quads('src'), self._quads('dst')
                rects = np.stack([
                    src[:, 0, 0], src[:, 0, 1], src[:, 2, 0], src[:, 2, 1]
                ], axis=1)
                with np.errstate(all='ignore'):
                    fwd = warp_ops.rect_to_quad_mats(rects, dst)
                    # Functional validation: the homography must carry the
                    # source corners onto the quad (the closed form loses
                    # precision on near-degenerate rounded cells).
                    homo = np.concatenate(
                        [src, np.ones((len(src), 4, 1))], axis=2
                    )
                    mapped = np.einsum('nij,nkj->nki', fwd, homo)
                    xy = mapped[:, :, :2] / mapped[:, :, 2:3]
                    err = np.abs(xy - dst).max(axis=(1, 2))
                bad = ~np.isfinite(fwd).all(axis=(1, 2))
                bad |= ~np.isfinite(err) | (err > 1e-6)
                if bad.any():
                    fwd[bad] = warp_ops.solve_perspective_batch(
                        src[bad], dst[bad]
                    )
                self._cache['fwd_mats'] = fwd
            if inverse and 'inv_mats' not in self._cache:
                # Consumers apply these projectively (divide by w), so the
                # matrix inverse needs NO normalization — normalizing by a
                # near-zero [2,2] entry is exactly what blows up on
                # ill-conditioned cells.
                fwd = self._cache['fwd_mats']
                with np.errstate(all='ignore'):
                    det = np.linalg.det(fwd)
                    safe = np.isfinite(det) & (np.abs(det) > 1e-12)
                    inv = np.linalg.inv(
                        np.where(safe[:, None, None], fwd, np.eye(3)[None])
                    )
                bad = ~(safe & np.isfinite(inv).all(axis=(1, 2)))
                if bad.any():
                    src, dst = self._quads('src'), self._quads('dst')
                    inv[bad] = warp_ops.solve_perspective_batch(
                        dst[bad], src[bad]
                    )
                self._cache['inv_mats'] = inv
        return self._cache[key]

    def _fwd_mats_for_cells(self, flat_cells: np.ndarray) -> np.ndarray:
        """(V, 3, 3) forward per-cell homographies for the given flat cell
        indices, solving ONLY the cells actually touched (point transforms
        hit a handful of the ~(R*C) cells; solving the full lattice per
        plan dominated the label co-transform benchmark)."""
        full = self._cache.get('fwd_mats')
        if full is not None:
            return full[flat_cells]
        uniq, inv = np.unique(flat_cells, return_inverse=True)
        cache = self._cache.setdefault('fwd_mats_partial', {})
        missing = [int(i) for i in uniq if int(i) not in cache]
        if missing:
            src = self._quads('src')[missing]
            dst = self._quads('dst')[missing]
            mats = warp_ops.solve_perspective_batch(src, dst)
            for cell, mat in zip(missing, mats):
                cache[cell] = mat
        return np.stack([cache[int(i)] for i in uniq])[inv]

    # ------------------------------------------------------------------
    # Forward point transform.
    # ------------------------------------------------------------------
    def map_points(self, np_xy: np.ndarray) -> np.ndarray:
        """Vectorized forward map of (V, 2) xy points into dst space."""
        if self.nop:
            return np.asarray(np_xy, dtype=np.float64).copy()
        if self.matrix is not None:
            return warp_ops.affine_np_points(
                self.matrix, np.asarray(np_xy, dtype=np.float32)
            ).astype(np.float64)

        assert self.src_lattice is not None and self.grid_size
        rows_max = self.src_lattice.shape[0] - 2
        cols_max = self.src_lattice.shape[1] - 2
        xy = np.asarray(np_xy, dtype=np.float64).reshape(-1, 2)
        cell_r = np.minimum(
            np.round(xy[:, 1]).astype(np.int64) // self.grid_size, rows_max
        )
        cell_c = np.minimum(
            np.round(xy[:, 0]).astype(np.int64) // self.grid_size, cols_max
        )
        mats = self._fwd_mats_for_cells(
            cell_r * (self.src_lattice.shape[1] - 1) + cell_c
        )
        homo = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
        out = np.einsum('vij,vj->vi', mats, homo)
        return out[:, :2] / out[:, 2:3]

    # ------------------------------------------------------------------
    # Dense backward map (lattice form only).
    # ------------------------------------------------------------------
    def backward_maps(self):
        """(map_y, map_x, coverage): per-dst-pixel src coords + covered mask.

        Uncovered pixels (outside every cell) keep zeros; the active mask
        excludes them downstream.
        """
        cached = self._cache.get('bwd')
        if cached is not None:
            return cached
        assert self.is_lattice
        dst_h, dst_w = self.dst_shape
        map_y = np.zeros((dst_h, dst_w), dtype=np.float32)
        map_x = np.zeros((dst_h, dst_w), dtype=np.float32)
        covered = np.zeros((dst_h, dst_w), dtype=bool)

        inv_mats = self._cell_mats(inverse=True)
        dst_quads = self._quads('dst')

        native = _native_lattice_backward_maps(
            dst_quads, inv_mats, (dst_h, dst_w)
        )
        if native is not None:
            self._cache['bwd'] = native
            return native

        for idx in range(dst_quads.shape[0]):
            quad = dst_quads[idx]
            x0 = max(int(np.floor(quad[:, 0].min())), 0)
            y0 = max(int(np.floor(quad[:, 1].min())), 0)
            x1 = min(int(np.ceil(quad[:, 0].max())), dst_w - 1)
            y1 = min(int(np.ceil(quad[:, 1].max())), dst_h - 1)
            if x1 < x0 or y1 < y0:
                continue
            inside = geometry.fill_poly(
                quad - np.asarray([x0, y0], dtype=np.float64),
                (y1 - y0 + 1, x1 - x0 + 1),
            ).astype(bool)
            yy, xx = np.nonzero(inside)
            if not len(yy):
                continue
            dy = yy + y0
            dx = xx + x0
            homo = np.stack([
                dx.astype(np.float64), dy.astype(np.float64),
                np.ones(len(dy), dtype=np.float64),
            ])
            src = inv_mats[idx] @ homo
            denom = src[2]
            keep = denom != 0
            with np.errstate(divide='ignore', invalid='ignore'):
                sx = src[0] / denom
                sy = src[1] / denom
            map_y[dy[keep], dx[keep]] = sy[keep]
            map_x[dy[keep], dx[keep]] = sx[keep]
            covered[dy[keep], dx[keep]] = True

        self._cache['bwd'] = (map_y, map_x, covered)
        return self._cache['bwd']

    def border_polygon(self) -> Polygon:
        """Perimeter of the dst lattice (clockwise)."""
        assert self.dst_lattice is not None
        lat = self.dst_lattice
        ring = np.concatenate([
            lat[0, :],                      # top row, left -> right
            lat[1:, -1],                    # right col, downward
            lat[-1, -2::-1],                # bottom row, right -> left
            lat[-2:0:-1, 0],                # left col, upward
        ])
        return Polygon.from_np_xy(ring)

    def shift_and_resize_point_xy(self, np_xy: np.ndarray) -> np.ndarray:
        """Map raw projected coordinates into the final dst frame."""
        sx, sy = self.shift_xy
        rx, ry = self.resize_ratio_xy
        out = np.asarray(np_xy, dtype=np.float64).copy()
        out[:, 0] = (out[:, 0] - sx) * rx
        out[:, 1] = (out[:, 1] - sy) * ry
        return out


# ----------------------------------------------------------------------------
# Constructors.
# ----------------------------------------------------------------------------

def nop_plan(shape: Tuple[int, int]) -> WarpPlan:
    return WarpPlan(src_shape=shape, dst_shape=shape, nop=True)


def rescale_plan_to(
    plan: WarpPlan,
    out_shape: Tuple[int, int],
    preserve_aspect: bool = True,
) -> WarpPlan:
    """Fold a final resize into the plan: the dst side rescales so the
    plan's output canvas IS ``out_shape``.

    This is how the batched synthesis pipeline keeps static shapes: every
    sample's randomized warp lands on one static canvas in a single
    resampling pass (no padded-canvas + second resize), and the local
    stretch encoded in the backward maps then carries the resize ratio for
    the label-height correction.  With ``preserve_aspect`` the content
    letterboxes into the canvas (scale = min ratio); the active mask marks
    the covered region.
    """
    out_h, out_w = out_shape
    h_d, w_d = plan.dst_shape
    if preserve_aspect:
        sy = sx = min(out_h / h_d, out_w / w_d)
    else:
        sy, sx = out_h / h_d, out_w / w_d

    if plan.nop or plan.matrix is not None:
        if plan.nop:
            fwd = np.eye(3, dtype=np.float64)
        else:
            fwd = np.eye(3, dtype=np.float64)
            m = np.asarray(plan.matrix, dtype=np.float64)
            fwd[:m.shape[0]] = m
        scale = np.diag([sx, sy, 1.0])
        return WarpPlan(
            src_shape=plan.src_shape,
            dst_shape=out_shape,
            matrix=(scale @ fwd).astype(np.float32),
        )

    assert plan.dst_lattice is not None
    return WarpPlan(
        src_shape=plan.src_shape,
        dst_shape=out_shape,
        src_lattice=plan.src_lattice,
        dst_lattice=plan.dst_lattice * np.asarray([sx, sy], dtype=np.float64),
        grid_size=plan.grid_size,
        shift_xy=plan.shift_xy,
        resize_ratio_xy=(
            plan.resize_ratio_xy[0] * sx, plan.resize_ratio_xy[1] * sy
        ),
    )


def matrix_plan(matrix: np.ndarray, src_shape: Tuple[int, int],
                dst_shape: Tuple[int, int]) -> WarpPlan:
    return WarpPlan(src_shape=src_shape, dst_shape=dst_shape,
                    matrix=np.asarray(matrix, dtype=np.float32))


def uniform_lattice(height: int, width: int, grid_size: int) -> np.ndarray:
    """(R, C, 2) float64 xy lattice with a forced last row/col at the edge."""
    ys = list(range(0, height, grid_size))
    if ys[-1] != height - 1:
        ys.append(height - 1)
    xs = list(range(0, width, grid_size))
    if xs[-1] != width - 1:
        xs.append(width - 1)
    gx, gy = np.meshgrid(np.asarray(xs, np.float64), np.asarray(ys, np.float64))
    return np.stack([gx, gy], axis=-1)


def lattice_plan(
    src_shape: Tuple[int, int],
    grid_size: int,
    project_xy: Callable[[np.ndarray], np.ndarray],
    resize_as_src: bool = False,
) -> WarpPlan:
    """Project a uniform src lattice and derive the dst canvas.

    The projected lattice shifts so its rounded min lands at the origin;
    with ``resize_as_src`` the dst canvas rescales back to the src shape.
    """
    height, width = src_shape
    src_lat = uniform_lattice(height, width, grid_size)
    rows, cols = src_lat.shape[:2]

    dst_flat = np.asarray(
        project_xy(src_lat.reshape(-1, 2)), dtype=np.float64
    )
    # Rounding before the min matches per-point integer shifting.
    shift_x = float(np.round(dst_flat[:, 0]).min())
    shift_y = float(np.round(dst_flat[:, 1]).min())
    dst_flat = dst_flat - np.asarray([shift_x, shift_y])

    ratio_x = ratio_y = 1.0
    if resize_as_src:
        raw_int = np.round(dst_flat).astype(np.int64)
        raw_h = int(raw_int[:, 1].max()) + 1
        raw_w = int(raw_int[:, 0].max()) + 1
        ratio_y = height / raw_h
        ratio_x = width / raw_w
        dst_flat = np.stack([
            np.clip(dst_flat[:, 0] * width / raw_w, 0, width - 1),
            np.clip(dst_flat[:, 1] * height / raw_h, 0, height - 1),
        ], axis=1)

    dst_lat = dst_flat.reshape(rows, cols, 2)
    dst_int = np.round(dst_lat).astype(np.int64)
    assert dst_int[..., 0].min() == 0 and dst_int[..., 1].min() == 0
    dst_shape = (int(dst_int[..., 1].max()) + 1, int(dst_int[..., 0].max()) + 1)
    if resize_as_src:
        assert dst_shape == src_shape

    return WarpPlan(
        src_shape=src_shape,
        dst_shape=dst_shape,
        src_lattice=src_lat,
        dst_lattice=dst_lat,
        grid_size=grid_size,
        shift_xy=(shift_x, shift_y),
        resize_ratio_xy=(ratio_x, ratio_y),
    )


# ----------------------------------------------------------------------------
# Appliers.
# ----------------------------------------------------------------------------

def _warp_mat(plan: WarpPlan, mat: np.ndarray) -> np.ndarray:
    if plan.matrix is not None:
        return warp_ops.warp_affine_np(mat, plan.matrix, plan.dst_shape)
    map_y, map_x, _ = plan.backward_maps()
    return warp_ops.remap_np(mat, map_y, map_x, 'bilinear')


def warp_image(plan: WarpPlan, image: Image) -> Image:
    # The result never carries an attached box: it lives on a new canvas.
    if plan.nop:
        return Image(mat=image.mat, mode=image.mode)
    return Image(mat=_warp_mat(plan, image.mat), mode=image.mode)


def warp_mask(plan: WarpPlan, mask: Mask) -> Mask:
    if plan.nop:
        return Mask(mat=mask.mat)
    return Mask(mat=_warp_mat(plan, mask.mat))


def warp_score_map(plan: WarpPlan, score_map: ScoreMap) -> ScoreMap:
    if plan.nop:
        return ScoreMap(mat=score_map.mat, is_prob=score_map.is_prob)
    mat = _warp_mat(plan, score_map.mat)
    if score_map.is_prob:
        mat = np.clip(mat, 0.0, 1.0)
    return ScoreMap(mat=mat, is_prob=score_map.is_prob)


def warp_points(plan: WarpPlan, points):
    from ...element import PointTuple
    if plan.nop:
        return PointTuple(points)
    xy = np.asarray(
        [(p.smooth_x, p.smooth_y) for p in points], dtype=np.float64
    ).reshape(-1, 2)
    return PointTuple.from_xy_pairs(
        (float(x), float(y)) for x, y in plan.map_points(xy)
    )


def warp_active_mask(plan: WarpPlan) -> Mask:
    if plan.nop:
        return Mask.from_shape(plan.dst_shape, value=1)
    if plan.is_lattice:
        active = Mask.from_shape(plan.dst_shape)
        # Projected lattice coordinates may overshoot the canvas edge by a
        # rounding hair (e.g. after rescale_plan_to); clip before filling.
        plan.border_polygon().to_clipped_polygon(plan.dst_shape).fill_mask(
            active
        )
        return active
    # Analytic form: the active region is the matrix image of the source
    # rectangle — a quad; fill it directly (a full-page remap of an
    # all-ones mask costs ~50ms/sample at production sizes).
    h, w = plan.src_shape
    corners = np.asarray(
        [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=np.float64
    )
    quad = plan.map_points(corners)
    active = Mask.from_shape(plan.dst_shape)
    Polygon.from_np_array(quad).to_clipped_polygon(plan.dst_shape).fill_mask(
        active
    )
    return active


def plan_content_box(plan: WarpPlan):
    """Per-plan active-content bounding box, analytically.

    The reference's corner trim (vkit/mechanism/distortion_policy/
    random_distortion.py:267-348) crops to the bounding box of the
    forward-mapped corner points.  For a matrix plan that is the bbox of
    the mapped source corners; for a lattice plan the bbox of the dst
    lattice perimeter.  Equivalent to
    ``warp_active_mask(plan).to_external_box()`` (±1 px of rasterization
    rounding) at none of its cost — no page-sized mask fill, no host scan.
    """
    from ...element import Box

    h, w = plan.dst_shape
    if plan.nop:
        return Box(up=0, down=h - 1, left=0, right=w - 1)
    if plan.is_lattice:
        ring = plan.dst_lattice.reshape(-1, 2)
    else:
        sh, sw = plan.src_shape
        corners = np.asarray(
            [[0, 0], [sw - 1, 0], [sw - 1, sh - 1], [0, sh - 1]],
            dtype=np.float64,
        )
        ring = plan.map_points(corners)
    xs = np.round(ring[:, 0]).astype(np.int64)
    ys = np.round(ring[:, 1]).astype(np.int64)
    return Box(
        up=int(np.clip(ys.min(), 0, h - 1)),
        down=int(np.clip(ys.max(), 0, h - 1)),
        left=int(np.clip(xs.min(), 0, w - 1)),
        right=int(np.clip(xs.max(), 0, w - 1)),
    )


def visualize_lattice(
    lattice: np.ndarray,
    shape: Optional[Tuple[int, int]] = None,
    line_color: str = 'black',
    background_color: str = 'white',
    line_width: int = 1,
) -> Image:
    """Debug rendering of a lattice's grid lines."""
    from PIL import Image as PilImage
    from PIL import ImageDraw

    pts = np.round(lattice).astype(np.int64)
    if shape is None:
        shape = (int(pts[..., 1].max()) + 1, int(pts[..., 0].max()) + 1)
    pil = PilImage.new('RGB', (shape[1], shape[0]), background_color)
    draw = ImageDraw.Draw(pil)
    rows, cols = pts.shape[:2]
    for r in range(rows):
        for c in range(cols):
            x, y = int(pts[r, c, 0]), int(pts[r, c, 1])
            if c + 1 < cols:
                draw.line((x, y, int(pts[r, c + 1, 0]), int(pts[r, c + 1, 1])),
                          fill=line_color, width=line_width)
            if r + 1 < rows:
                draw.line((x, y, int(pts[r + 1, c, 0]), int(pts[r + 1, c, 1])),
                          fill=line_color, width=line_width)
    return Image.from_pil_image(pil)
